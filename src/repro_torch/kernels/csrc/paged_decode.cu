// Paged near-window GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` (with its update
// `_online_block_update`) in src/repro/kernels/paged_attention.py, and
// computes what `ref.paged_decode_attention_ref(..., cur_k, cur_v,
// skip_extent, far_k, far_v, far_table, far_valid)` computes: the engine's
// decode path, where the pool is read-only inside the layer loop and the
// current token is attended from cur_k / cur_v rather than from the pool.
//
//   out[b, g*n_rep + r] = softmax over { the CAP far summaries selected by
//       far_table[b] with far_valid > 0 (mode="full" only) }
//     + { pool keys of slot b at positions pos with pos < t, pos > t - W,
//       pos >= 0 } + { the current token }
//   (t = seq_lens[b]); retired slots (slot_active == 0) write zeros.
//
// With the far view the kernel also writes far_util[b, g, c]: far entry
// c's final normalised probability summed over the n_rep query heads of kv
// head g (zero for retired slots). The wrapper sums these partials over g
// in a fixed order (no atomics), so the host's utility EMA -- and the far
// table it selects -- is the same from run to run.
//
// Design. One thread block per (slot, kv head); a runtime loop inside the
// block walks the window blocks [ext_lo, ext_hi) -- the TPU's sequential
// grid axis becomes this loop. The extent is derived in-kernel from
// window_base / seq_lens / slot_active with the formula of
// ref.active_block_extent; skip_extent = 0 walks [0, NB). Each step reads
// block_table[b, i] itself, stages that block's (BT, hd) K and V rows of
// this kv head in shared memory as f32, scores the n_rep grouped query
// heads against them with f32 FMAs and folds them into an online f32
// softmax (m, l, acc per query head). After the loop the current token is
// one last online step. The output is acc / max(l, 1e-20), in the input
// type.
//
// The far view is the first online step(s): its CAP rows of this kv head
// are gathered through far_table into the same key tile, BT entries at a
// time, and their scaled scores are also kept in shared memory (n_rep x CAP
// floats) until the final (m, l) gives each one's probability. With null
// far pointers none of this runs and the kernel computes bitwise what it
// computes without the far view (that path is its own instantiation,
// kFar = false, with no far code in it); a far view whose entries are all
// masked is a bitwise no-op too (an all-masked tile leaves (m, l, acc)
// unchanged).
//
// Bound. Decode attention reads each K/V byte of the window once and does
// 4 flops per K/V element pair (QK and PV, n_rep heads share the bytes): it
// is bound by memory bytes. At full qwen2.5-32b width (hd 128, KV 8,
// n_rep 5), batch 8, W 512 and BT 16 there are NB = 33 blocks of 64 KiB
// (K+V, all kv heads) per slot: about 17.3 MB per layer, about 5.2 us at
// 3.35 TB/s. This first kernel is simple, not fast: 64 thread blocks fill
// half the card, loads are not pipelined and the dots run on CUDA cores
// (no wgmma/TMA, no split-KV); those are later work.
#include "online_softmax.cuh"

namespace {

template <typename T, bool kFar>
__global__ void paged_decode_kernel(
    const T* __restrict__ q,            // (B, H, hd)
    const T* __restrict__ pool_k,       // (P, BT, KV, hd)
    const T* __restrict__ pool_v,       // (P, BT, KV, hd)
    const int* __restrict__ block_table,  // (B, NB)
    const int* __restrict__ window_base,  // (B,)
    const int* __restrict__ seq_lens,     // (B,)  position of the current token
    const int* __restrict__ slot_active,  // (B,)
    const T* __restrict__ cur_k,        // (B, KV, hd)
    const T* __restrict__ cur_v,        // (B, KV, hd)
    const T* __restrict__ far_k,        // (B, MAXC, KV, hd) or null
    const T* __restrict__ far_v,        // (B, MAXC, KV, hd) or null
    const int* __restrict__ far_table,  // (B, CAP)
    const int* __restrict__ far_valid,  // (B, CAP)
    T* __restrict__ out,                // (B, H, hd)
    float* __restrict__ far_util,       // (B, KV, CAP) or null
    int H, int KV, int hd, int BT, int NB, int MAXC, int CAP,
    int near_window, int skip_extent, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int n_rep = H / KV;
  const int tid = threadIdx.x, nthr = blockDim.x;
  T* o = out + ((size_t)b * H + (size_t)g * n_rep) * hd;

  const bool active = slot_active[b] > 0;
  float* util = kFar ? far_util + ((size_t)b * KV + g) * CAP : nullptr;
  if (!active) {  // retired slot: every key is masked; the output is zero
    for (int e = tid; e < n_rep * hd; e += nthr) kvrm::store_as(o + e, 0.f);
    if (kFar)
      for (int c = tid; c < CAP; c += nthr) util[c] = 0.f;
    return;
  }
  const int wb = window_base[b], t = seq_lens[b];

  kvrm::Tile tile = kvrm::carve(smem, n_rep, hd, BT);
  const T* qb = q + ((size_t)b * H + (size_t)g * n_rep) * hd;
  for (int e = tid; e < n_rep * hd; e += nthr) tile.Qs[e] = kvrm::to_f32(qb[e]);
  kvrm::init_state(tile);

  int lo = 0, hi = NB;
  if (skip_extent) {  // ref.active_block_extent, for an active slot
    const int lo_pos = max(0, t + 1 - near_window);
    lo = min(max(kvrm::floordiv(lo_pos - wb, BT), 0), NB);
    hi = min(max(kvrm::floordiv(t - wb, BT) + 1, 0), NB);
    hi = max(hi, lo);
  }
  __syncthreads();

  // the far view: CAP gathered summaries, BT at a time, scores kept in FarS
  float* FarS = smem + kvrm::tile_floats(n_rep, hd, BT);  // n_rep x CAP
  if (kFar) {
    const int* ftab = far_table + (size_t)b * CAP;
    const int* fval = far_valid + (size_t)b * CAP;
    for (int c0 = 0; c0 < CAP; c0 += BT) {
      const int nk = min(BT, CAP - c0);
      for (int e = tid; e < nk * hd; e += nthr) {
        const int j = e / hd, d = e - j * hd;
        const int idx = min(max(ftab[c0 + j], 0), MAXC - 1);
        const size_t off = (((size_t)b * MAXC + idx) * KV + g) * hd + d;
        tile.Ks[(size_t)j * (hd + 1) + d] = kvrm::to_f32(far_k[off]);
        tile.Vs[(size_t)j * hd + d] = kvrm::to_f32(far_v[off]);
      }
      __syncthreads();
      kvrm::online_step(
          tile, nk, scale, [&](int, int j) { return fval[c0 + j] > 0; },
          FarS + c0, CAP);
    }
  }

  const size_t row_stride = (size_t)KV * hd;  // one token of the pool
  for (int i = lo; i < hi; ++i) {
    const int blk = block_table[(size_t)b * NB + i];
    const size_t base = (size_t)blk * BT * row_stride + (size_t)g * hd;
    for (int e = tid; e < BT * hd; e += nthr) {
      const int j = e / hd, d = e - j * hd;
      const size_t off = base + (size_t)j * row_stride + d;
      tile.Ks[(size_t)j * (hd + 1) + d] = kvrm::to_f32(pool_k[off]);
      tile.Vs[(size_t)j * hd + d] = kvrm::to_f32(pool_v[off]);
    }
    __syncthreads();
    const int pos0 = wb + i * BT;
    kvrm::online_step(tile, BT, scale, [&](int, int j) {
      const int pos = pos0 + j;
      return pos < t && pos > t - near_window && pos >= 0;
    });
  }

  // the current token: one last online step (valid for an active slot)
  const size_t cb = ((size_t)b * KV + g) * hd;
  for (int d = tid; d < hd; d += nthr) {
    tile.Ks[d] = kvrm::to_f32(cur_k[cb + d]);
    tile.Vs[d] = kvrm::to_f32(cur_v[cb + d]);
  }
  __syncthreads();
  kvrm::online_step(tile, 1, scale, [](int, int) { return true; });

  for (int e = tid; e < n_rep * hd; e += nthr) {
    const int r = e / hd;
    kvrm::store_as(o + e, tile.Acc[e] / fmaxf(tile.L[r], 1e-20f));
  }
  if (kFar) {  // each far entry's final probability, summed over r
    for (int c = tid; c < CAP; c += nthr) {
      float u = 0.f;
      for (int r = 0; r < n_rep; ++r) {
        const float s = FarS[(size_t)r * CAP + c];
        if (s != -INFINITY)
          u += expf(s - tile.M[r]) / fmaxf(tile.L[r], 1e-20f);
      }
      util[c] = u;
    }
  }
}

size_t smem_bytes(int n_rep, int hd, int BT, int CAP) {
  return (kvrm::tile_floats(n_rep, hd, BT) + (size_t)n_rep * CAP) *
         sizeof(float);
}

template <typename T>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* block_table, const void* window_base,
           const void* seq_lens, const void* slot_active, const void* cur_k,
           const void* cur_v, const void* far_k, const void* far_v,
           const void* far_table, const void* far_valid, void* out,
           void* far_util, int B, int H, int KV, int hd, int BT, int NB,
           int MAXC, int CAP, int near_window, int skip_extent, float scale,
           int threads, void* stream) {
  const bool far = far_k != nullptr;
  const size_t smem = smem_bytes(H / KV, hd, BT, far ? CAP : 0);
  auto kernel = far ? paged_decode_kernel<T, true>
                    : paged_decode_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, KV);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)pool_k, (const T*)pool_v,
      (const int*)block_table, (const int*)window_base, (const int*)seq_lens,
      (const int*)slot_active, (const T*)cur_k, (const T*)cur_v,
      (const T*)far_k, (const T*)far_v, (const int*)far_table,
      (const int*)far_valid, (T*)out, (float*)far_util, H, KV, hd, BT, NB,
      MAXC, CAP, near_window, skip_extent, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one launch needs (bytes); the wrapper checks it. CAP is 0
// without the far view.
size_t paged_decode_smem_bytes(int n_rep, int hd, int BT, int CAP) {
  return smem_bytes(n_rep, hd, BT, CAP);
}

// Null far_k / far_v / far_table / far_valid / far_util: no far view.
#define PAGED_DECODE_ENTRY(NAME, T)                                          \
  int NAME(const void* q, const void* pool_k, const void* pool_v,           \
           const void* block_table, const void* window_base,                \
           const void* seq_lens, const void* slot_active, const void* cur_k, \
           const void* cur_v, const void* far_k, const void* far_v,         \
           const void* far_table, const void* far_valid, void* out,         \
           void* far_util, int B, int H, int KV, int hd, int BT, int NB,    \
           int MAXC, int CAP, int near_window, int skip_extent,             \
           float scale, int threads, void* stream) {                        \
    return launch<T>(q, pool_k, pool_v, block_table, window_base, seq_lens, \
                     slot_active, cur_k, cur_v, far_k, far_v, far_table,    \
                     far_valid, out, far_util, B, H, KV, hd, BT, NB, MAXC,  \
                     CAP, near_window, skip_extent, scale, threads, stream); \
  }

PAGED_DECODE_ENTRY(paged_decode_bf16, __nv_bfloat16)
PAGED_DECODE_ENTRY(paged_decode_f32, float)

}  // extern "C"
