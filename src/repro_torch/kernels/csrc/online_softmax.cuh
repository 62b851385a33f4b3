// Shared pieces of the kernels: element conversion (all four; the narrow
// codes of the quantized KV tier widen exactly to f32), floor
// division, and one flash-style online-softmax step over a tile of keys held
// in shared memory (paged_decode.cu, chunked_prefill.cu, prefill_flash.cu).
//
// Every sum is f32. A key masked for a query row scores -inf and adds
// nothing; a tile whose keys are all masked for a row leaves that row's
// (m, l, acc) exactly as it was (m_new == m_prev, corr == 1, p == 0), so
// walking extra fully-masked blocks is a bitwise no-op. That is what makes
// the extent skip (DESIGN.md §12) bitwise identical to the full walk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kvrm {

// running-max seed, as in the Pallas kernels (NEG_INF = -1e30)
constexpr float kNegInit = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// quantized KV codes: every e4m3 and int8 value is an f32 value
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as .astype(bf16)
}

// Python-style floor division (the reference's `//` on possibly negative ints)
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Shared-memory working set of one thread block.
//   Qs  : nq x hd            queries (f32)
//   Ks  : kcap x (hd + 1)    key tile, padded row stride (conflict-free dots)
//   Vs  : kcap x hd          value tile
//   S   : nq x kcap          scores, then probabilities
//   Acc : nq x hd            unnormalised output
//   M, L, Corr : nq          running max, running sum, this step's rescale
struct Tile {
  float* Qs;
  float* Ks;
  float* Vs;
  float* S;
  float* Acc;
  float* M;
  float* L;
  float* Corr;
  int nq, hd, kcap;
};

__host__ __device__ inline size_t tile_floats(int nq, int hd, int kcap) {
  return (size_t)nq * hd + (size_t)kcap * (hd + 1) + (size_t)kcap * hd +
         (size_t)nq * kcap + (size_t)nq * hd + 3 * (size_t)nq;
}

__device__ inline Tile carve(float* smem, int nq, int hd, int kcap) {
  Tile t;
  t.nq = nq;
  t.hd = hd;
  t.kcap = kcap;
  t.Qs = smem;
  t.Ks = t.Qs + (size_t)nq * hd;
  t.Vs = t.Ks + (size_t)kcap * (hd + 1);
  t.S = t.Vs + (size_t)kcap * hd;
  t.Acc = t.S + (size_t)nq * kcap;
  t.M = t.Acc + (size_t)nq * hd;
  t.L = t.M + nq;
  t.Corr = t.L + nq;
  return t;
}

__device__ inline void init_state(const Tile& t) {
  for (int e = threadIdx.x; e < t.nq * t.hd; e += blockDim.x) t.Acc[e] = 0.f;
  for (int r = threadIdx.x; r < t.nq; r += blockDim.x) {
    t.M[r] = kNegInit;
    t.L[r] = 0.f;
  }
}

// One online-softmax step over the first `nk` keys of the tile.
// valid(row, key) says whether query `row` may attend key `key`.
// `raw`, where given, also receives each scaled score (-inf where masked)
// at raw[row * raw_ld + key], for a caller that needs a key's probability
// after the last step (the far view's utility).
// Entry and exit are block-wide barriers (the tile must be loaded).
template <typename Valid>
__device__ inline void online_step(const Tile& t, int nk, float scale,
                                   Valid valid, float* raw = nullptr,
                                   int raw_ld = 0) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int hd = t.hd, ks = hd + 1;
  // scores: one (row, key) dot product per thread, f32 FMAs
  for (int e = tid; e < t.nq * nk; e += nthr) {
    const int r = e / nk, j = e - r * nk;
    float s = -INFINITY;
    if (valid(r, j)) {
      const float* qr = t.Qs + (size_t)r * hd;
      const float* kj = t.Ks + (size_t)j * ks;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kj[d], acc);
      s = acc * scale;
    }
    t.S[(size_t)r * t.kcap + j] = s;
    if (raw != nullptr) raw[(size_t)r * raw_ld + j] = s;
  }
  __syncthreads();
  // per-row running max / sum update
  for (int r = tid; r < t.nq; r += nthr) {
    float* sr = t.S + (size_t)r * t.kcap;
    const float m_prev = t.M[r];
    float m_new = m_prev;
    for (int j = 0; j < nk; ++j) m_new = fmaxf(m_new, sr[j]);
    float psum = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float s = sr[j];
      const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
      sr[j] = p;
      psum += p;
    }
    const float corr = expf(m_prev - m_new);
    t.L[r] = t.L[r] * corr + psum;
    t.M[r] = m_new;
    t.Corr[r] = corr;
  }
  __syncthreads();
  // acc = acc * corr + P . V
  for (int e = tid; e < t.nq * hd; e += nthr) {
    const int r = e / hd, d = e - r * hd;
    const float* pr = t.S + (size_t)r * t.kcap;
    float pv = 0.f;
    for (int j = 0; j < nk; ++j) pv = fmaf(pr[j], t.Vs[(size_t)j * hd + d], pv);
    t.Acc[e] = t.Acc[e] * t.Corr[r] + pv;
  }
  __syncthreads();
}

}  // namespace kvrm
