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
// k_scale / v_scale (P, KV) f32 one scale per (physical block, kv head); a
// pool element loads as to_f32(code) * scale[blk, g], blk read from the
// block table. The chunk's own K/V, q and the output stay in T.
//
// Design. Grid (B, KV, ceil(C * n_rep / BM)): one thread block owns BM
// query rows (chunk token c, grouped head r) of one kv head. A runtime loop
// walks the pool blocks of the extent, staging each block's (BT, hd) K/V
// rows of that kv head in shared memory as f32, then walks the chunk's own
// K/V in tiles of BT tokens up to the block's last causal row. Both loops
// feed one online f32 softmax per row (m, l, acc). The TPU grid's
// sequential block axis becomes these loops; the vmap over slots becomes
// the grid's first axis.
//
// Bound. At full qwen2.5-32b width (H 40, KV 8, hd 128), batch 8, C = 64
// and a full W = 512 context, the kernel must move ~30 MB (context K/V
// 17.3 MB, q, the chunk's K/V, the output) and do ~5.7e9 flops (QK and
// PV): about 9 us at 3.35 TB/s against about 6 us at the 989 TFLOP/s bf16
// tensor rate, so it is bound by memory bytes, though not by far. Rows of
// one block reuse each staged K/V tile BM times from shared memory. Dots
// run on CUDA cores in f32; wgmma/TMA tiles are later work.
#include <type_traits>

#include "online_softmax.cuh"

namespace {

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

// One entry per (q dtype, pool dtype). k_scale / v_scale: (P, KV) f32 for a
// quantized pool, null otherwise.
#define CHUNKED_PREFILL_ENTRY(NAME, T, TP)                                   \
  int NAME(const void* q, const void* pool_k, const void* pool_v,           \
           const void* cur_k, const void* cur_v, const void* k_scale,       \
           const void* v_scale, const void* block_table,                    \
           const void* window_base, const void* start_pos,                  \
           const void* n_valid, void* out, int B, int C, int H, int KV,     \
           int hd, int BT, int NB, int near_window, int skip_extent,        \
           float scale, int BM, int threads, void* stream) {                \
    return launch<T, TP>(q, pool_k, pool_v, cur_k, cur_v, k_scale, v_scale, \
                         block_table, window_base, start_pos, n_valid, out, \
                         B, C, H, KV, hd, BT, NB, near_window, skip_extent, \
                         scale, BM, threads, stream);                       \
  }

CHUNKED_PREFILL_ENTRY(chunked_prefill_bf16, __nv_bfloat16, __nv_bfloat16)
CHUNKED_PREFILL_ENTRY(chunked_prefill_f32, float, float)
CHUNKED_PREFILL_ENTRY(chunked_prefill_bf16_fp8, __nv_bfloat16, __nv_fp8_e4m3)
CHUNKED_PREFILL_ENTRY(chunked_prefill_bf16_int8, __nv_bfloat16, int8_t)
CHUNKED_PREFILL_ENTRY(chunked_prefill_f32_fp8, float, __nv_fp8_e4m3)
CHUNKED_PREFILL_ENTRY(chunked_prefill_f32_int8, float, int8_t)

}  // extern "C"
