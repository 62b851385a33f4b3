// Dense (full-sequence) GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_prefill_kernel` in
// src/repro/kernels/prefill_attention.py (launched by
// `prefill_attention_pallas`). Computes, for q (B, S, H, hd) and k/v
// (B, S, KV, hd), query head h attending kv head h / n_rep:
//   out[b, i, h] = softmax_j(q_i . k_j * scale) . v_j
// over keys j that are valid for query i: j <= i when causal, and
// j > i - window when window > 0. Scores and the online softmax (running
// max seeded at -1e30, denominator clamped at 1e-20) are f32; the output
// is rounded once to the input dtype. Any S >= 1: the ragged last query
// block and key tile are masked here (the Pallas wrapper asserts
// S % 128 == 0).
//
// Grid. The TPU kernel runs a (B, H, nQ, nK) grid whose last axis is
// sequential and carries (m, l, acc) in VMEM scratch. Here the grid is
// (B, KV, ceil(S * n_rep / 64)): one thread block owns 64 query rows
// (token s = m / n_rep, grouped head r = m % n_rep) of ONE kv head, so the
// n_rep query heads of that kv head share every staged K/V tile. A runtime
// loop over key tiles replaces the sequential grid axis; its trip count
// covers only the keys some row of the block may attend (up to the block's
// last row when causal, from its first row's window edge when windowed),
// so the causal upper triangle and the region below the window are never
// read.
//
// bf16: tensor cores (prefill_flash_mma_kernel), built as FlashAttention-2
// from the pieces in mma_tile.cuh. 4 warps, 16 rows each. The Q tile is
// staged once in shared memory and read into A fragments with ldmatrix.
// K and V tiles of 64 keys go through a 2-stage shared-memory ring, filled
// with 16-byte cp.async copies (one commit group per tile; tile i+1 is in
// flight while tile i is computed, `cp.async.wait_group 1`); key rows past
// the block's last key are zero-filled, so a masked p = 0 never meets
// garbage. Rows are padded by 8 elements, so ldmatrix's eight 16-byte rows
// fall in distinct banks. S = Q.K^T by mma.m16n8k16 (bf16 in, f32
// accumulators), masked to -inf, online softmax over each row's quad of
// threads; p is rounded to bf16 in registers and is the A fragment of
// P.V (V read with ldmatrix.trans), whose f32 accumulator (16 x hd per
// warp) stays in registers. The plain version rounds p to bf16 too
// (`attention_dense`: p.to(v.dtype)); it also rounds the scores, which
// stay f32 here. hd: a multiple of 16 up to 256.
//
// f32: CUDA cores (prefill_flash_kernel): each K/V tile is staged in f32
// behind a barrier and fed to `kvrm::online_step`; tensor cores on f32
// would compute in TF32, which cannot meet the f32 tolerance.
//
// Bound. The encoder's attention at seamless-m4t-medium width (B 1,
// S 1000, H = KV = 16, hd 64, non-causal) must move 8.2 MB (q, k, v once,
// the output once) and do 4.1e9 flops (QK and PV): 2.4 us at 3.35 TB/s
// against 4.1 us at the 989 TFLOP/s bf16 tensor rate, so it is bound by
// operations. mma.sync reaches only part of that rate (the full rate is
// wgmma's, fed by TMA: later work); the grid is 256 blocks there.
#include "mma_tile.cuh"
#include "online_softmax.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;     // query rows (token, grouped head) per block
constexpr int kKeys = 64;     // keys per K/V tile
constexpr int kWarps = 4;     // 16 rows each
constexpr int kPad = 8;       // elements added to each shared-memory row

__host__ __device__ constexpr size_t mma_smem_bytes(int hd) {
  // Q (kRows rows) + 2 stages of K and of V (kKeys rows each), bf16
  return (size_t)(kRows + 4 * kKeys) * (hd + kPad) * sizeof(__nv_bfloat16);
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32) prefill_flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, S, H, HD)
    const __nv_bfloat16* __restrict__ k,   // (B, S, KV, HD)
    const __nv_bfloat16* __restrict__ v,   // (B, S, KV, HD)
    __nv_bfloat16* __restrict__ out,       // (B, S, H, HD)
    int S, int H, int KV, int causal, int window, float scale_log2) {
  using namespace kvrm::mma;
  constexpr int LD = HD + kPad;        // shared row stride (elements)
  constexpr int CPR = HD / 8;          // 16-byte chunks per row
  constexpr int KC = HD / 16;          // k-steps of Q.K^T; d pairs of P.V
  constexpr int NT = kKeys / 8;        // score tiles (8 keys) per warp
  constexpr int NTHR = kWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kRows * LD;         // 2 stages of kKeys x LD
  __nv_bfloat16* Vs = Ks + 2 * kKeys * LD;     // 2 stages of kKeys x LD

  const int b = blockIdx.x, g = blockIdx.y;
  const int n_rep = H / KV;
  const int m0 = blockIdx.z * kRows;
  const int mrows = min(kRows, S * n_rep - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // row m of this block -> q / out offset of token (m0 + m) / n_rep, head
  // g * n_rep + (m0 + m) % n_rep
  auto qoff = [&](int m) {
    const int gm = m0 + m, s = gm / n_rep, r = gm - s * n_rep;
    return (((size_t)b * S + s) * H + (size_t)g * n_rep + r) * HD;
  };

  // keys any row of this block may attend: [k_lo, k_hi), never empty
  const int s_first = m0 / n_rep, s_last = (m0 + mrows - 1) / n_rep;
  const int k_lo = window > 0 ? max(0, s_first - window + 1) : 0;
  const int k_hi = causal ? s_last + 1 : S;
  const int n_tiles = (k_hi - k_lo + kKeys - 1) / kKeys;

  const size_t rstride = (size_t)KV * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * rstride + (size_t)g * HD;
  const __nv_bfloat16* vb = v + (size_t)b * S * rstride + (size_t)g * HD;
  // key tile t into stage st, rows at or past k_hi zero-filled: the block's
  // threads copy the tile's kKeys * CPR 16-byte chunks in passes of NTHR
  // (CPR need not divide NTHR, so a pass may end inside a row)
  static_assert(kKeys * CPR % NTHR == 0, "whole passes over a tile");
  auto fetch = [&](int t, int st) {
    const int j0 = k_lo + t * kKeys;
#pragma unroll
    for (int i = 0; i < kKeys * CPR / NTHR; ++i) {
      const int c = tid + i * NTHR, jj = c / CPR, d = (c - jj * CPR) * 8;
      const bool ok = j0 + jj < k_hi;
      const size_t o = ok ? (size_t)(j0 + jj) * rstride + d : 0;
      const int so = (st * kKeys + jj) * LD + d;
      cp_async16(Ks + so, kb + o, ok);
      cp_async16(Vs + so, vb + o, ok);
    }
  };

  // Q rows past the block's last row are zero-filled (never stored)
  for (int c = tid; c < kRows * CPR; c += NTHR) {
    const int m = c / CPR, d = (c - m * CPR) * 8;
    const bool ok = m < mrows;
    cp_async16(Qs + m * LD + d, ok ? q + qoff(m) + d : q, ok);
  }
  cp_async_commit();  // Q
  fetch(0, 0);
  cp_async_commit();  // tile 0

  // this thread's rows: r0 (c0, c1) and r0 + 8 (c2, c3), their tokens
  const int r0 = warp * 16 + (lane >> 2);
  const int tok0 = (m0 + r0) / n_rep, tok1 = (m0 + r0 + 8) / n_rep;
  const int qc2 = (lane & 3) * 2;

  float acc[2 * KC][4];
#pragma unroll
  for (int dt = 0; dt < 2 * KC; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_run[2] = {kvrm::kNegInit, kvrm::kNegInit};
  float l_run[2] = {0.f, 0.f};

  // ldmatrix row addresses of this lane (see mma_tile.cuh):
  //   Q (A):    row lane % 16, column half lane / 16
  //   K (B):    key (lane % 8) + 8 (lane / 16), d half (lane / 8) % 2
  //   V (B^T):  key (lane % 8) + 8 ((lane / 8) % 2), d half lane / 16
  const __nv_bfloat16* q_lane = Qs + (warp * 16 + (lane & 15)) * LD +
                                (lane >> 4) * 8;
  const int k_lane = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  // up to hd 128 the warp's Q fragments stay in registers (4 hd / 16 of
  // them); above, they are read again for each key tile
  constexpr bool kQReg = HD <= 128;
  uint32_t qf[kQReg ? KC : 1][4];
  if constexpr (kQReg) {
    cp_async_wait<1>();   // Q has landed (tile 0 may be in flight)
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) ldmatrix_x4(qf[kc], q_lane + kc * 16);
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) fetch(t + 1, (t + 1) & 1);
    cp_async_commit();     // (empty after the last tile)
    cp_async_wait<1>();    // this thread's copies of tile t have landed
    __syncthreads();       // ... and every thread's
    const __nv_bfloat16* ks = Ks + (t & 1) * kKeys * LD;
    const __nv_bfloat16* vs = Vs + (t & 1) * kKeys * LD;

    // S = Q . K^T: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      if constexpr (kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
      } else {
        ldmatrix_x4(a, q_lane + kc * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + k_lane + np * 16 * LD + kc * 16);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // mask where some key of the tile may be invalid for some row of the
    // block (ragged end, causal diagonal, window edge)
    const int j0 = k_lo + t * kKeys;
    const bool edge = j0 + kKeys > k_hi ||
                      (causal && j0 + kKeys - 1 > s_first) ||
                      (window > 0 && j0 <= s_last - window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + nt * 8 + qc2 + (e & 1);
          const int tok = e < 2 ? tok0 : tok1;
          const bool ok = j < k_hi && (!causal || j <= tok) &&
                          (window <= 0 || j > tok - window);
          if (!ok) s[nt][e] = -INFINITY;
        }
    }

    float corr[2];
    online_softmax_step<NT>(s, m_run, l_run, corr, scale_log2);
#pragma unroll
    for (int dt = 0; dt < 2 * KC; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // acc += P . V: p rounded to bf16, the A fragment straight from s
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < KC; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + v_lane + kk * 16 * LD + dp * 16);
        mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage t & 1 is refilled by the next iteration
  }

  // the row sums: the quad's four shares
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= mrows) continue;
    const float den = fmaxf(l_run[i], 1e-20f);
    __nv_bfloat16* o = out + qoff(r) + qc2;
#pragma unroll
    for (int dt = 0; dt < 2 * KC; ++dt)
      *reinterpret_cast<uint32_t*>(o + dt * 8) =
          pack_bf16(acc[dt][2 * i] / den, acc[dt][2 * i + 1] / den);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int KV, int causal, int window, float scale,
               void* stream) {
  const size_t smem = mma_smem_bytes(HD);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_flash_mma_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = S * (H / KV);
  dim3 grid(B, KV, (rows + kRows - 1) / kRows);
  prefill_flash_mma_kernel<HD>
      <<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, H, KV, causal,
          window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

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

size_t prefill_flash_mma_smem_bytes(int hd) { return mma_smem_bytes(hd); }

// hd: a multiple of 16 up to 256; anything else returns
// cudaErrorInvalidValue and launches nothing
int prefill_flash_bf16(const void* q, const void* k, const void* v, void* out,
                       int B, int S, int H, int KV, int hd, int causal,
                       int window, float scale, void* stream) {
#define KVRM_HD(n)                                                          \
  case n:                                                                   \
    return launch_mma<n>(q, k, v, out, B, S, H, KV, causal, window, scale, \
                         stream);
  switch (hd) {
    KVRM_HD(16) KVRM_HD(32) KVRM_HD(48) KVRM_HD(64)
    KVRM_HD(80) KVRM_HD(96) KVRM_HD(112) KVRM_HD(128)
    KVRM_HD(144) KVRM_HD(160) KVRM_HD(176) KVRM_HD(192)
    KVRM_HD(208) KVRM_HD(224) KVRM_HD(240) KVRM_HD(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KVRM_HD
}

int prefill_flash_f32(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int H, int KV, int hd, int causal,
                      int window, float scale, int BM, int KT, int threads,
                      void* stream) {
  return launch<float>(q, k, v, out, B, S, H, KV, hd, causal, window, scale,
                       BM, KT, threads, stream);
}

}  // extern "C"
