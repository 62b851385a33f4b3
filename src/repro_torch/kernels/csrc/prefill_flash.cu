// Dense (full-sequence) GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_prefill_kernel` in
// src/repro/kernels/prefill_attention.py (launched by
// `prefill_attention_pallas`). Computes, for q (B, S, H, hd) and k/v
// (B, S, KV, hd), query head h attending kv head h / n_rep:
//   out[b, i, h] = softmax_j(q_i . k_j * scale) . v_j
// over keys j that are valid for query i: j <= i when causal, and
// j > i - window when window > 0. Scores, the online softmax (running max
// seeded at -1e30, denominator clamped at 1e-20) and P.V are f32; the
// output is rounded once to the input dtype. Any S >= 1: the ragged last
// query block and key tile are masked here (the Pallas wrapper asserts
// S % 128 == 0).
//
// Design. The TPU kernel runs a (B, H, nQ, nK) grid whose last axis is
// sequential and carries (m, l, acc) in VMEM scratch. Here the grid is
// (B, KV, ceil(S * n_rep / BM)), as in chunked_prefill.cu: one thread
// block owns BM query rows (token s, grouped head r) of ONE kv head, so the
// n_rep query heads of that kv head share every staged K/V tile. A runtime
// loop over key tiles of KT tokens replaces the sequential grid axis; its
// trip count covers only the keys some row of the block may attend (up to
// the block's last row when causal, from its first row's window edge when
// windowed), so the causal upper triangle and the region below the window
// are never read. Each tile feeds `kvrm::online_step`; a key masked for a
// row adds nothing to that row, and a tile fully masked for a row leaves
// its (m, l, acc) bitwise as they were.
//
// Bound. The encoder's attention at seamless-m4t-medium width (B 1,
// S 1000, H = KV = 16, hd 64, non-causal) must move 8.2 MB (q, k, v once,
// the output once) and do 4.1e9 flops (QK and PV): 2.4 us at 3.35 TB/s
// against 4.1 us at the 989 TFLOP/s bf16 tensor rate, so it is bound by
// operations. This kernel runs its dots on CUDA cores in f32 from shared
// memory (each staged K/V tile reused by BM rows), far from that bound;
// wgmma tiles fed by TMA are later work.
#include "online_softmax.cuh"

namespace {

template <typename T>
__global__ void prefill_flash_kernel(
    const T* __restrict__ q,     // (B, S, H, hd)
    const T* __restrict__ k,     // (B, S, KV, hd)
    const T* __restrict__ v,     // (B, S, KV, hd)
    T* __restrict__ out,         // (B, S, H, hd)
    int S, int H, int KV, int hd, int causal, int window, float scale,
    int BM, int KT) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int n_rep = H / KV;
  const int m0 = blockIdx.z * BM;
  const int mrows = min(BM, S * n_rep - m0);
  const int tid = threadIdx.x, nthr = blockDim.x;

  // row m of this block -> token s = (m0 + m) / n_rep, head g*n_rep + r
  auto qoff = [&](int m) {
    const int gm = m0 + m, s = gm / n_rep, r = gm - s * n_rep;
    return (((size_t)b * S + s) * H + (size_t)g * n_rep + r) * hd;
  };
  auto row_s = [&](int m) { return (m0 + m) / n_rep; };

  kvrm::Tile tile = kvrm::carve(smem, mrows, hd, KT);
  for (int e = tid; e < mrows * hd; e += nthr) {
    const int m = e / hd, d = e - m * hd;
    tile.Qs[e] = kvrm::to_f32(q[qoff(m) + d]);
  }
  kvrm::init_state(tile);

  // keys any row of this block may attend: [k_lo, k_hi)
  const int s_first = row_s(0), s_last = row_s(mrows - 1);
  const int k_lo = window > 0 ? max(0, s_first - window + 1) : 0;
  const int k_hi = causal ? s_last + 1 : S;
  __syncthreads();

  const size_t row_stride = (size_t)KV * hd;
  const size_t base = (size_t)b * S * row_stride + (size_t)g * hd;
  for (int j0 = k_lo; j0 < k_hi; j0 += KT) {
    const int nk = min(KT, k_hi - j0);          // ragged last tile
    for (int e = tid; e < nk * hd; e += nthr) {
      const int j = e / hd, d = e - j * hd;
      const size_t off = base + (size_t)(j0 + j) * row_stride + d;
      tile.Ks[(size_t)j * (hd + 1) + d] = kvrm::to_f32(k[off]);
      tile.Vs[(size_t)j * hd + d] = kvrm::to_f32(v[off]);
    }
    __syncthreads();
    kvrm::online_step(tile, nk, scale, [&](int m, int jj) {
      const int j = j0 + jj, s = row_s(m);
      return (!causal || j <= s) && (window <= 0 || j > s - window);
    });
  }

  for (int e = tid; e < mrows * hd; e += nthr) {
    const int m = e / hd, d = e - m * hd;
    kvrm::store_as(out + qoff(m) + d,
                   tile.Acc[e] / fmaxf(tile.L[m], 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int hd, int causal, int window, float scale,
           int BM, int KT, int threads, void* stream) {
  const size_t smem = kvrm::tile_floats(BM, hd, KT) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = S * (H / KV);
  dim3 grid(B, KV, (rows + BM - 1) / BM);
  prefill_flash_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, KV, hd, causal,
      window, scale, BM, KT);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t prefill_flash_smem_bytes(int bm, int hd, int kt) {
  return kvrm::tile_floats(bm, hd, kt) * sizeof(float);
}

int prefill_flash_bf16(const void* q, const void* k, const void* v, void* out,
                       int B, int S, int H, int KV, int hd, int causal,
                       int window, float scale, int BM, int KT, int threads,
                       void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, causal, window,
                               scale, BM, KT, threads, stream);
}

int prefill_flash_f32(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int H, int KV, int hd, int causal,
                      int window, float scale, int BM, int KT, int threads,
                      void* stream) {
  return launch<float>(q, k, v, out, B, S, H, KV, hd, causal, window, scale,
                       BM, KT, threads, stream);
}

}  // extern "C"
