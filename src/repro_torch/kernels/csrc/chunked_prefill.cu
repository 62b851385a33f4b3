// Chunked paged-prefill GQA attention for Hopper (sm_90a), all slots in one
// launch.
//
// Replaces the Pallas TPU kernel `_chunk_kernel` in
// src/repro/kernels/prefill_attention.py, which the JAX engine vmaps over
// the slots (src/repro/models/transformer.py: prefill_chunk). Computes
// `ref.chunked_prefill_attention_ref` for every slot b: query i of the
// chunk (position p_i = start + i) attends
//   * pool context at positions pos < start, pos > p_i - W, pos >= 0, from
//     the window blocks of block_table[b] (only blocks in the
//     chunk_block_extent range when skip_extent is set), then
//   * the chunk's own K/V causally: j <= i, start + j > p_i - W,
//     j < n_valid.
// Rows i >= n_valid are zero; a slot with n_valid = 0 writes zeros and
// reads nothing.
//
// Quantized tier (DESIGN.md §10; the `quant=True` branch of
// `_chunk_kernel`): the pools hold fp8_e4m3 or int8 codes (TP) and
// k_scale / v_scale (P, KV) f32 one scale per (physical block, kv head),
// blk read from the block table: code * scale[blk, g] is the element's
// value (applied per element by the f32 kernel, per key column by the
// bf16 one, below). The chunk's own K/V, q and the output stay in T.
//
// Two kernels, by q's dtype.
//
// bf16 (bf16, fp8_e4m3 and int8 pools): tensor cores
// (chunked_prefill_mma_kernel), built from the pieces in mma_tile.cuh as
// prefill_flash.cu's bf16 kernel is. Grid (B, KV, ceil(C * n_rep / 64)):
// one thread block of 4 warps owns 64 query rows (chunk token c, grouped
// head r) of one kv head, 16 rows a warp, so one warp's rows may span
// several chunk tokens and every mask is per row. Q is staged once with
// cp.async; its A fragments stay in registers up to hd 128. The keys come
// in tiles of 64: first the window, as logical rows wb + 64t .. wb + 64t +
// 63, each row gathered from block_table[b, idx / BT], row idx % BT, with
// 16-byte cp.async copies (any BT); then the chunk's own K/V (row stride
// KV * hd) up to the block's last causal row. Rows that no query row of
// the block may attend (decided from positions alone) and rows past the
// window are zero-filled, not read. A 2-stage ring keeps tile t + 1 in
// flight while tile t is computed. With skip_extent only the tiles that
// meet chunk_block_extent's blocks are visited, else every window tile: a
// tile masked for every row leaves (m, l, acc) as they were (corr 1, p 0),
// so skip on and off are bitwise equal. S = Q.K^T by mma.m16n8k16 with f32
// accumulators, masked to -inf, online softmax per row
// (online_softmax_step); p rounded to bf16 is the A fragment of P.V, as
// the plain version rounds p to the pool's dtype; out = acc / max(l,
// 1e-20). hd: a multiple of 16 up to 256; any other returns
// cudaErrorInvalidValue.
//
// A narrow pool stages its raw codes in the ring (16 codes per 16-byte
// copy) with each key row's k and v scale (4-byte cp.async), then widens
// the tile to bf16 in shared memory, exactly (every int8 and e4m3 value is
// a bf16 value). The scales stay f32: k_scale multiplies the tile's score
// columns before the softmax, v_scale p's columns before p is rounded to
// bf16. The chunk's own K/V, full width, is copied straight into the bf16
// tile. So a narrow pool needs one bf16 K/V tile, not two.
//
// f32 (f32, fp8_e4m3 and int8 pools): CUDA cores (chunked_prefill_kernel).
// Grid (B, KV, ceil(C * n_rep / BM)): one thread block owns BM query rows
// (chunk token c, grouped head r) of one kv head. A runtime loop walks the
// pool blocks of the extent, staging each block's (BT, hd) K/V rows of
// that kv head in shared memory as f32, then walks the chunk's own K/V in
// tiles of BT tokens up to the block's last causal row. Both loops feed
// one online f32 softmax per row (m, l, acc). Tensor cores on f32 would
// compute in TF32, which cannot meet the f32 tolerance.
//
// In both, the TPU grid's sequential block axis becomes loops inside the
// thread block, and the vmap over slots becomes the grid's first axis.
//
// Bound. At full qwen2.5-32b width (H 40, KV 8, hd 128), batch 8, C = 64
// and a full W = 512 context, the kernel must move ~30 MB (context K/V
// 17.3 MB, q, the chunk's K/V, the output) and do ~5.7e9 flops (QK and
// PV): about 9 us at 3.35 TB/s against about 6 us at the 989 TFLOP/s bf16
// tensor rate, so it is bound by memory bytes, though not by far. Rows of
// one block reuse each staged K/V tile 64 times from shared memory.
// mma.sync reaches only part of the tensor rate (wgmma's, fed by TMA, is
// later work).
#include <type_traits>

#include "mma_tile.cuh"
#include "online_softmax.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 q: tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;     // query rows (chunk token, grouped head) per block
constexpr int kKeys = 64;     // keys per K/V tile
constexpr int kWarps = 4;     // 16 rows each
constexpr int kPad = 8;       // bf16 elements added to each shared-memory row

// bf16 pool: the Q tile and 2 stages of K and of V, bf16 rows padded by
// kPad. Narrow pool: the Q tile and one K and one V tile in bf16, 2 stages
// of raw K and V codes (hd bytes a row) and of each key row's k and v scale.
__host__ __device__ constexpr size_t mma_smem_bytes(int hd, bool quant) {
  return quant ? (size_t)(kRows + 2 * kKeys) * (hd + kPad) * 2 +
                     (size_t)4 * kKeys * hd + (size_t)4 * kKeys * sizeof(float)
               : (size_t)(kRows + 4 * kKeys) * (hd + kPad) * 2;
}

// Two narrow codes (x's low 16 bits, the first code in the low byte) ->
// two bf16 in one register, exactly: int8 codes fit bf16's 8-bit
// significand, e4m3 values its mantissa and range.
template <typename TP>
__device__ __forceinline__ uint32_t widen2(uint32_t x);
template <>
__device__ __forceinline__ uint32_t widen2<int8_t>(uint32_t x) {
  return kvrm::mma::pack_bf16((float)(int8_t)(x & 0xffu),
                              (float)(int8_t)(x >> 8));
}
template <>
__device__ __forceinline__ uint32_t widen2<__nv_fp8_e4m3>(uint32_t x) {
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)x, __NV_E4M3)));
  return kvrm::mma::pack_bf16(f.x, f.y);
}

// TP: the pool's element (bf16, or a narrow code with k_scale / v_scale)
template <int HD, typename TP>
__global__ void __launch_bounds__(kWarps * 32) chunked_prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q,       // (B, C, H, HD)
    const TP* __restrict__ pool_k,             // (P, BT, KV, HD)
    const TP* __restrict__ pool_v,             // (P, BT, KV, HD)
    const __nv_bfloat16* __restrict__ cur_k,   // (B, C, KV, HD)
    const __nv_bfloat16* __restrict__ cur_v,   // (B, C, KV, HD)
    const float* __restrict__ k_scale,         // (P, KV), narrow pools only
    const float* __restrict__ v_scale,         // (P, KV), narrow pools only
    const int* __restrict__ block_table,       // (B, NB)
    const int* __restrict__ window_base,       // (B,)
    const int* __restrict__ start_pos,         // (B,)
    const int* __restrict__ n_valid,           // (B,)
    __nv_bfloat16* __restrict__ out,           // (B, C, H, HD)
    int C, int H, int KV, int BT, int NB, int near_window, int skip_extent,
    float scale_log2) {
  using namespace kvrm::mma;
  constexpr bool kQuant = !std::is_same<TP, __nv_bfloat16>::value;
  constexpr int LD = HD + kPad;        // shared bf16 row stride (elements)
  constexpr int CPR = HD / 8;          // 16-byte chunks per bf16 row
  constexpr int CPRQ = HD / 16;        // 16-byte chunks per row of codes
  constexpr int KC = HD / 16;          // k-steps of Q.K^T; d pairs of P.V
  constexpr int NT = kKeys / 8;        // score tiles (8 keys) per warp
  constexpr int NTHR = kWarps * 32;
  constexpr int kStages = kQuant ? 1 : 2;   // bf16 K/V tiles
  static_assert(kKeys * CPR % NTHR == 0, "whole passes over a bf16 tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kRows * LD;              // kStages x kKeys x LD
  __nv_bfloat16* Vs = Ks + kStages * kKeys * LD;    // kStages x kKeys x LD
  // narrow pool only: 2 stages of raw codes (kKeys x HD) and of scales
  TP* Kr = reinterpret_cast<TP*>(Vs + kStages * kKeys * LD);
  TP* Vr = Kr + 2 * kKeys * HD;
  float* Ksc = reinterpret_cast<float*>(Vr + 2 * kKeys * HD);
  float* Vsc = Ksc + 2 * kKeys;

  const int b = blockIdx.x, g = blockIdx.y;
  const int n_rep = H / KV;
  const int m0 = blockIdx.z * kRows;
  const int mrows = min(kRows, C * n_rep - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nv = n_valid[b];

  // row m of this block -> q / out offset of chunk token (m0 + m) / n_rep,
  // head g * n_rep + (m0 + m) % n_rep
  auto qoff = [&](int m) {
    const int gm = m0 + m, c = gm / n_rep, r = gm - c * n_rep;
    return (((size_t)b * C + c) * H + (size_t)g * n_rep + r) * HD;
  };

  if (nv <= 0) {  // idle slot row of the fixed-shape step
    for (int c = tid; c < mrows * CPR; c += NTHR) {
      const int m = c / CPR, d = (c - m * CPR) * 8;
      *reinterpret_cast<uint4*>(out + qoff(m) + d) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const int start = start_pos[b], wb = window_base[b];
  const int W = near_window;
  // chunk tokens of the block's first and last rows
  const int c_first = m0 / n_rep, c_last = (m0 + mrows - 1) / n_rep;

  // window tiles: logical rows idx = 64t .. 64t + 63 at positions wb + idx
  const int n_idx = NB * BT;
  int t_lo = 0, t_hi = (n_idx + kKeys - 1) / kKeys;
  if (skip_extent) {  // the tiles that meet ref.chunk_block_extent's blocks
    int lo = 0, hi = 0;
    if (start > wb) {
      const int lo_pos = max(0, start - W + 1);
      lo = min(max(kvrm::floordiv(lo_pos - wb, BT), 0), NB);
      hi = min(max(kvrm::floordiv(start - 1 - wb, BT) + 1, 0), NB);
      hi = max(hi, lo);
    }
    t_lo = lo * BT / kKeys;
    t_hi = hi > lo ? (hi * BT + kKeys - 1) / kKeys : t_lo;
  }
  const int n_pool = t_hi - t_lo;
  // window rows some row of the block may attend (pos >= 0, pos < start,
  // pos > start + c_first - W): [f_lo, f_hi); the rest are zero-filled
  const int f_lo = max(0, max(start + c_first - W + 1, 0) - wb);
  const int f_hi = min(n_idx, start - wb);
  // the chunk's own keys some row may attend: j < j_end
  const int j_end = min(nv, c_last + 1);
  const int n_tiles = n_pool + (j_end + kKeys - 1) / kKeys;

  const size_t rstride = (size_t)KV * HD;
  const int* tbl = block_table + (size_t)b * NB;
  // pool offset (elements) of window row idx, column d of kv head g
  auto pool_off = [&](int idx, int d) {
    const int blk = __ldg(tbl + idx / BT);
    return ((size_t)blk * BT + idx % BT) * rstride + (size_t)g * HD + d;
  };
  // window tile t into stage st: bf16 rows into the ring; codes into the
  // raw ring, with each row's scales
  auto fetch_pool = [&](int t, int st) {
    const int i0 = t * kKeys;
    if constexpr (!kQuant) {
#pragma unroll
      for (int i = 0; i < kKeys * CPR / NTHR; ++i) {
        const int c = tid + i * NTHR, jj = c / CPR, d = (c - jj * CPR) * 8;
        const int idx = i0 + jj;
        const bool ok = idx >= f_lo && idx < f_hi;
        const size_t o = ok ? pool_off(idx, d) : 0;
        const int so = (st * kKeys + jj) * LD + d;
        cp_async16(Ks + so, pool_k + o, ok);
        cp_async16(Vs + so, pool_v + o, ok);
      }
    } else {
      for (int c = tid; c < kKeys * CPRQ; c += NTHR) {
        const int jj = c / CPRQ, d = (c - jj * CPRQ) * 16;
        const int idx = i0 + jj;
        const bool ok = idx >= f_lo && idx < f_hi;
        const size_t o = ok ? pool_off(idx, d) : 0;
        const int so = (st * kKeys + jj) * HD + d;
        cp_async16(Kr + so, pool_k + o, ok);
        cp_async16(Vr + so, pool_v + o, ok);
      }
      if (tid < kKeys) {
        const int idx = i0 + tid;
        const bool ok = idx >= f_lo && idx < f_hi;
        const size_t o = ok ? (size_t)__ldg(tbl + idx / BT) * KV + g : 0;
        cp_async4(Ksc + st * kKeys + tid, k_scale + o, ok);
        cp_async4(Vsc + st * kKeys + tid, v_scale + o, ok);
      }
    }
  };
  // the chunk's own tile u into bf16 stage st, rows at or past j_end
  // zero-filled
  auto fetch_cur = [&](int u, int st) {
    const int j0 = u * kKeys;
#pragma unroll
    for (int i = 0; i < kKeys * CPR / NTHR; ++i) {
      const int c = tid + i * NTHR, jj = c / CPR, d = (c - jj * CPR) * 8;
      const bool ok = j0 + jj < j_end;
      const size_t o = ok ? (((size_t)b * C + j0 + jj) * KV + g) * HD + d : 0;
      const int so = (st * kKeys + jj) * LD + d;
      cp_async16(Ks + so, cur_k + o, ok);
      cp_async16(Vs + so, cur_v + o, ok);
    }
  };

  // Q rows past the block's last row are zero-filled (never stored)
  for (int c = tid; c < kRows * CPR; c += NTHR) {
    const int m = c / CPR, d = (c - m * CPR) * 8;
    const bool ok = m < mrows;
    cp_async16(Qs + m * LD + d, ok ? q + qoff(m) + d : q, ok);
  }
  cp_async_commit();  // Q
  if (n_pool > 0) {
    fetch_pool(t_lo, 0);
  } else if constexpr (!kQuant) {
    fetch_cur(0, 0);
  }
  cp_async_commit();  // tile 0 (a narrow pool's chunk tiles come later)

  // this thread's rows: r0 (c0, c1) and r0 + 8 (c2, c3), their chunk tokens
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

  // ldmatrix row addresses of this lane, as in prefill_flash.cu
  const __nv_bfloat16* q_lane = Qs + (warp * 16 + (lane & 15)) * LD +
                                (lane >> 4) * 8;
  const int k_lane = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  constexpr bool kQReg = HD <= 128;
  uint32_t qf[kQReg ? KC : 1][4];
  if constexpr (kQReg) {
    cp_async_wait<1>();   // Q has landed (tile 0 may be in flight)
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) ldmatrix_x4(qf[kc], q_lane + kc * 16);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const bool pool_tile = t < n_pool;
    if (t + 1 < n_pool) {
      fetch_pool(t_lo + t + 1, (t + 1) & 1);
    } else if constexpr (!kQuant) {
      if (t + 1 < n_tiles) fetch_cur(t + 1 - n_pool, (t + 1) & 1);
    }
    cp_async_commit();     // (empty when nothing was fetched)
    cp_async_wait<1>();    // this thread's copies of tile t have landed
    __syncthreads();       // ... and every thread's
    if constexpr (kQuant) {
      if (pool_tile) {
        // widen stage t & 1's codes into the bf16 tile: 16 codes a chunk
        const TP* kr = Kr + (t & 1) * kKeys * HD;
        const TP* vr = Vr + (t & 1) * kKeys * HD;
        for (int c = tid; c < kKeys * CPRQ; c += NTHR) {
          const int jj = c / CPRQ, d = (c - jj * CPRQ) * 16;
#pragma unroll
          for (int kv = 0; kv < 2; ++kv) {
            const uint4 raw =
                *reinterpret_cast<const uint4*>((kv ? vr : kr) + jj * HD + d);
            const uint32_t x[4] = {raw.x, raw.y, raw.z, raw.w};
            uint32_t w[8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              w[2 * e] = widen2<TP>(x[e] & 0xffffu);
              w[2 * e + 1] = widen2<TP>(x[e] >> 16);
            }
            uint4* dst =
                reinterpret_cast<uint4*>((kv ? Vs : Ks) + jj * LD + d);
            dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
            dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
          }
        }
      } else {
        fetch_cur(t - n_pool, 0);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    const __nv_bfloat16* ks = Ks + (kQuant ? 0 : (t & 1) * kKeys * LD);
    const __nv_bfloat16* vs = Vs + (kQuant ? 0 : (t & 1) * kKeys * LD);

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

    if (pool_tile) {
      if constexpr (kQuant) {  // k_scale of each key's block, in f32
        const float* sc = Ksc + (t & 1) * kKeys;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 k2 = *reinterpret_cast<const float2*>(sc + nt * 8 + qc2);
          s[nt][0] *= k2.x;
          s[nt][1] *= k2.y;
          s[nt][2] *= k2.x;
          s[nt][3] *= k2.y;
        }
      }
      // masks where some key of the tile may be invalid for some row
      const int i0 = (t_lo + t) * kKeys, p0 = wb + i0;
      const bool edge = i0 + kKeys > n_idx || p0 < 0 ||
                        p0 + kKeys > start || p0 <= start + c_last - W;
      if (edge) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = i0 + nt * 8 + qc2 + (e & 1), pos = wb + idx;
            const int tok = e < 2 ? tok0 : tok1;
            const bool ok = idx < n_idx && pos >= 0 && pos < start &&
                            pos > start + tok - W;
            if (!ok) s[nt][e] = -INFINITY;
          }
      }
    } else {  // the chunk's own keys, causally
      const int j0 = (t - n_pool) * kKeys;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + nt * 8 + qc2 + (e & 1);
          const int tok = e < 2 ? tok0 : tok1;
          const bool ok = j <= tok && j > tok - W && j < nv;
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
    if constexpr (kQuant) {
      if (pool_tile) {  // v_scale of each key's block, in f32, before p's
                        // rounding to bf16
        const float* sc = Vsc + (t & 1) * kKeys;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 v2 = *reinterpret_cast<const float2*>(sc + nt * 8 + qc2);
          s[nt][0] *= v2.x;
          s[nt][1] *= v2.y;
          s[nt][2] *= v2.x;
          s[nt][3] *= v2.y;
        }
      }
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
    __syncthreads();  // the stage (the bf16 tile) is refilled next
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
    const bool live = (i ? tok1 : tok0) < nv;   // rows c >= n_valid are zero
    const float den = fmaxf(l_run[i], 1e-20f);
    __nv_bfloat16* o = out + qoff(r) + qc2;
#pragma unroll
    for (int dt = 0; dt < 2 * KC; ++dt)
      *reinterpret_cast<uint32_t*>(o + dt * 8) =
          live ? pack_bf16(acc[dt][2 * i] / den, acc[dt][2 * i + 1] / den)
               : 0u;
  }
}

template <int HD, typename TP>
int launch_mma(const void* q, const void* pool_k, const void* pool_v,
               const void* cur_k, const void* cur_v, const void* k_scale,
               const void* v_scale, const void* block_table,
               const void* window_base, const void* start_pos,
               const void* n_valid, void* out, int B, int C, int H, int KV,
               int BT, int NB, int near_window, int skip_extent, float scale,
               void* stream) {
  constexpr bool kQuant = !std::is_same<TP, __nv_bfloat16>::value;
  if (kQuant != (k_scale != nullptr) || kQuant != (v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes(HD, kQuant);
  auto kernel = chunked_prefill_mma_kernel<HD, TP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = C * (H / KV);
  dim3 grid(B, KV, (rows + kRows - 1) / kRows);
  kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const TP*)pool_k, (const TP*)pool_v,
      (const __nv_bfloat16*)cur_k, (const __nv_bfloat16*)cur_v,
      (const float*)k_scale, (const float*)v_scale, (const int*)block_table,
      (const int*)window_base, (const int*)start_pos, (const int*)n_valid,
      (__nv_bfloat16*)out, C, H, KV, BT, NB, near_window, skip_extent,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// one instantiation per hd: a multiple of 16 up to 256
template <typename TP>
int launch_mma_hd(const void* q, const void* pool_k, const void* pool_v,
                  const void* cur_k, const void* cur_v, const void* k_scale,
                  const void* v_scale, const void* block_table,
                  const void* window_base, const void* start_pos,
                  const void* n_valid, void* out, int B, int C, int H, int KV,
                  int hd, int BT, int NB, int near_window, int skip_extent,
                  float scale, void* stream) {
#define KVRM_HD(n)                                                           \
  case n:                                                                    \
    return launch_mma<n, TP>(q, pool_k, pool_v, cur_k, cur_v, k_scale,      \
                             v_scale, block_table, window_base, start_pos,  \
                             n_valid, out, B, C, H, KV, BT, NB, near_window, \
                             skip_extent, scale, stream);
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

// ---------------------------------------------------------------------------
// f32 q: CUDA cores
// ---------------------------------------------------------------------------

// T: q / cur / out element; TP: the pool's element (T, or a narrow code)
template <typename T, typename TP>
__global__ void chunked_prefill_kernel(
    const T* __restrict__ q,             // (B, C, H, hd)
    const TP* __restrict__ pool_k,       // (P, BT, KV, hd)
    const TP* __restrict__ pool_v,       // (P, BT, KV, hd)
    const T* __restrict__ cur_k,         // (B, C, KV, hd)
    const T* __restrict__ cur_v,         // (B, C, KV, hd)
    const float* __restrict__ k_scale,   // (P, KV), quantized pools only
    const float* __restrict__ v_scale,   // (P, KV), quantized pools only
    const int* __restrict__ block_table,   // (B, NB)
    const int* __restrict__ window_base,   // (B,)
    const int* __restrict__ start_pos,     // (B,)
    const int* __restrict__ n_valid,       // (B,)
    T* __restrict__ out,                 // (B, C, H, hd)
    int C, int H, int KV, int hd, int BT, int NB, int near_window,
    int skip_extent, float scale, int BM) {
  constexpr bool kQuant = !std::is_same<T, TP>::value;
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int n_rep = H / KV;
  const int m0 = blockIdx.z * BM;
  const int mrows = min(BM, C * n_rep - m0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nv = n_valid[b];
  const int start = start_pos[b];
  const int wb = window_base[b];

  // row m of this block -> chunk token c = (m0 + m) / n_rep, head g*n_rep + r
  auto qoff = [&](int m) {
    const int gm = m0 + m, c = gm / n_rep, r = gm - c * n_rep;
    return (((size_t)b * C + c) * H + (size_t)g * n_rep + r) * hd;
  };

  if (nv <= 0) {  // idle slot row of the fixed-shape step
    for (int e = tid; e < mrows * hd; e += nthr) {
      const int m = e / hd, d = e - m * hd;
      kvrm::store_as(out + qoff(m) + d, 0.f);
    }
    return;
  }

  kvrm::Tile tile = kvrm::carve(smem, mrows, hd, BT);
  for (int e = tid; e < mrows * hd; e += nthr) {
    const int m = e / hd, d = e - m * hd;
    tile.Qs[e] = kvrm::to_f32(q[qoff(m) + d]);
  }
  kvrm::init_state(tile);

  int lo = 0, hi = NB;
  if (skip_extent) {  // ref.chunk_block_extent
    if (start > wb) {
      const int lo_pos = max(0, start - near_window + 1);
      lo = min(max(kvrm::floordiv(lo_pos - wb, BT), 0), NB);
      hi = min(max(kvrm::floordiv(start - 1 - wb, BT) + 1, 0), NB);
      hi = max(hi, lo);
    } else {
      lo = hi = 0;
    }
  }
  __syncthreads();

  // chunk token of local row m
  auto row_c = [&](int m) { return (m0 + m) / n_rep; };

  const size_t row_stride = (size_t)KV * hd;
  for (int i = lo; i < hi; ++i) {
    const int blk = block_table[(size_t)b * NB + i];
    const size_t base = (size_t)blk * BT * row_stride + (size_t)g * hd;
    [[maybe_unused]] float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {  // this physical block's scales (kv head g)
      ks = k_scale[(size_t)blk * KV + g];
      vs = v_scale[(size_t)blk * KV + g];
    }
    for (int e = tid; e < BT * hd; e += nthr) {
      const int j = e / hd, d = e - j * hd;
      const size_t off = base + (size_t)j * row_stride + d;
      if constexpr (kQuant) {
        tile.Ks[(size_t)j * (hd + 1) + d] = kvrm::to_f32(pool_k[off]) * ks;
        tile.Vs[(size_t)j * hd + d] = kvrm::to_f32(pool_v[off]) * vs;
      } else {
        tile.Ks[(size_t)j * (hd + 1) + d] = kvrm::to_f32(pool_k[off]);
        tile.Vs[(size_t)j * hd + d] = kvrm::to_f32(pool_v[off]);
      }
    }
    __syncthreads();
    const int pos0 = wb + i * BT;
    kvrm::online_step(tile, BT, scale, [&](int m, int j) {
      const int pos = pos0 + j;
      const int qpos = start + row_c(m);
      return pos < start && pos > qpos - near_window && pos >= 0;
    });
  }

  // the chunk's own K/V, causally; tiles past the last row's token or past
  // n_valid are fully masked for every row of this block and are skipped
  const int j_end = min(nv, row_c(mrows - 1) + 1);
  for (int j0 = 0; j0 < j_end; j0 += BT) {
    const int nk = min(BT, j_end - j0);
    for (int e = tid; e < nk * hd; e += nthr) {
      const int j = e / hd, d = e - j * hd;
      const size_t off = (((size_t)b * C + j0 + j) * KV + g) * hd + d;
      tile.Ks[(size_t)j * (hd + 1) + d] = kvrm::to_f32(cur_k[off]);
      tile.Vs[(size_t)j * hd + d] = kvrm::to_f32(cur_v[off]);
    }
    __syncthreads();
    kvrm::online_step(tile, nk, scale, [&](int m, int jj) {
      const int j = j0 + jj, c = row_c(m);
      return j <= c && j > c - near_window && j < nv;
    });
  }

  for (int e = tid; e < mrows * hd; e += nthr) {
    const int m = e / hd, d = e - m * hd;
    const float v = row_c(m) < nv ? tile.Acc[e] / fmaxf(tile.L[m], 1e-20f)
                                  : 0.f;
    kvrm::store_as(out + qoff(m) + d, v);
  }
}

template <typename T, typename TP>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* cur_k, const void* cur_v, const void* k_scale,
           const void* v_scale, const void* block_table,
           const void* window_base, const void* start_pos,
           const void* n_valid, void* out, int B, int C, int H, int KV,
           int hd, int BT, int NB, int near_window, int skip_extent,
           float scale, int BM, int threads, void* stream) {
  constexpr bool kQuant = !std::is_same<T, TP>::value;
  if (kQuant != (k_scale != nullptr) || kQuant != (v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = kvrm::tile_floats(BM, hd, BT) * sizeof(float);
  auto kernel = chunked_prefill_kernel<T, TP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = C * (H / KV);
  dim3 grid(B, KV, (rows + BM - 1) / BM);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const TP*)pool_k, (const TP*)pool_v, (const T*)cur_k,
      (const T*)cur_v, (const float*)k_scale, (const float*)v_scale,
      (const int*)block_table, (const int*)window_base,
      (const int*)start_pos, (const int*)n_valid, (T*)out, C, H, KV, hd, BT,
      NB, near_window, skip_extent, scale, BM);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t chunked_prefill_smem_bytes(int bm, int hd, int BT) {
  return kvrm::tile_floats(bm, hd, BT) * sizeof(float);
}

// shared memory of the bf16 (tensor-core) kernel; quant: a narrow pool
size_t chunked_prefill_mma_smem_bytes(int hd, int quant) {
  return mma_smem_bytes(hd, quant != 0);
}

// One entry per (q dtype, pool dtype). k_scale / v_scale: (P, KV) f32 for a
// quantized pool, null otherwise. The bf16 entries launch the tensor-core
// kernel, which fixes its own rows per block and threads (bm and threads
// are the f32 kernel's); an hd it does not take returns
// cudaErrorInvalidValue and launches nothing.
#define CHUNKED_PREFILL_ENTRY(NAME, CALL)                                    \
  int NAME(const void* q, const void* pool_k, const void* pool_v,           \
           const void* cur_k, const void* cur_v, const void* k_scale,       \
           const void* v_scale, const void* block_table,                    \
           const void* window_base, const void* start_pos,                  \
           const void* n_valid, void* out, int B, int C, int H, int KV,     \
           int hd, int BT, int NB, int near_window, int skip_extent,        \
           float scale, int BM, int threads, void* stream) {                \
    return CALL;                                                            \
  }
#define KVRM_MMA(TP)                                                         \
  launch_mma_hd<TP>(q, pool_k, pool_v, cur_k, cur_v, k_scale, v_scale,      \
                    block_table, window_base, start_pos, n_valid, out, B, C, \
                    H, KV, hd, BT, NB, near_window, skip_extent, scale,     \
                    stream)
#define KVRM_F32(TP)                                                         \
  launch<float, TP>(q, pool_k, pool_v, cur_k, cur_v, k_scale, v_scale,      \
                    block_table, window_base, start_pos, n_valid, out, B, C, \
                    H, KV, hd, BT, NB, near_window, skip_extent, scale, BM, \
                    threads, stream)

CHUNKED_PREFILL_ENTRY(chunked_prefill_bf16, KVRM_MMA(__nv_bfloat16))
CHUNKED_PREFILL_ENTRY(chunked_prefill_f32, KVRM_F32(float))
CHUNKED_PREFILL_ENTRY(chunked_prefill_bf16_fp8, KVRM_MMA(__nv_fp8_e4m3))
CHUNKED_PREFILL_ENTRY(chunked_prefill_bf16_int8, KVRM_MMA(int8_t))
CHUNKED_PREFILL_ENTRY(chunked_prefill_f32_fp8, KVRM_F32(__nv_fp8_e4m3))
CHUNKED_PREFILL_ENTRY(chunked_prefill_f32_int8, KVRM_F32(int8_t))

}  // extern "C"
