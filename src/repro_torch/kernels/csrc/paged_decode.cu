// Paged near-window GQA decode attention for Hopper (sm_90a).
//
// paged_decode_kernel (and, for bf16 q in the engine form,
// paged_decode_split_kernel with paged_decode_combine_kernel, or with
// paged_decode_combine_far_kernel under the far view, below) replaces the
// Pallas TPU kernel `_decode_kernel` (with its update
// `_online_block_update`) in src/repro/kernels/paged_attention.py,
// and computes what `ref.paged_decode_attention_ref(..., cur_k, cur_v,
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
// Pool-only form (null cur_k / cur_v; `_decode_kernel`'s own form, where
// the current token was written to the pool first): the window takes
// pos <= t and there is no current-token step. It is its own instantiation
// (kCur = false), so the engine's (kCur = true) is what it was, and it is
// not offered with the far view.
//
// paged_decode_db_kernel replaces `_decode_kernel_db` (the
// `prefetch_depth=1` variant): the pool-only form, on same-type or narrow
// pools, skip on or off, no far view. It walks the same extent, but block
// i+1's raw K and V rows of kv head g (BT x hd each, in the pool's own
// element type, so narrow codes copy as bytes) are fetched into one of two
// shared-memory stages with 16-byte `cp.async.cg` copies, one commit group
// per block, before block i is waited on (`cp.async.wait_group 1`) and
// computed -- the reference's `_start_fetch(i + 1)` ahead of the compute.
// The loop is primed with ext_lo when the extent is non-empty and issues no
// fetch at or past ext_hi. After each wait the stage is widened into the
// same padded f32 tile with the same expressions (to_f32(code) * scale, in
// the same order), and the same `online_step` runs: the two kernels agree
// bitwise by construction. dma = 0 keeps the two-stage rotation with
// synchronous element loads (the reference's direct-read fallback); it is
// the caller's switch, never a fallback the kernel takes on its own. The
// async copies need 16-byte stage rows (hd * sizeof(TP)) and 16-byte-aligned
// pools: the launch refuses anything else.
//
// Quantized tier (DESIGN.md §10; the `quant=True` branch of
// `_decode_kernel`): the pools hold fp8_e4m3 or int8 codes (TP) and
// k_scale / v_scale (P, KV) f32 hold one scale per (physical block, kv
// head). A pool element loads as to_f32(code) * scale[blk, g], blk being the
// block id read from the block table -- exactly the reference's dequantize
// of the gathered window. q, the current token and the output stay in T,
// and the current token is attended at full width. The far view and the
// quantized tier are exclusive (the launch refuses both at once).
//
// With the far view the kernel also writes far_util[b, g, c]: far entry
// c's final normalised probability summed over the n_rep query heads of kv
// head g (zero for retired slots). The wrapper sums these partials over g
// in a fixed order (no atomics), so the host's utility EMA -- and the far
// table it selects -- is the same from run to run.
//
// Split-KV (bf16 q; bf16, fp8_e4m3 and int8 pools; the engine form, and with a
// bf16 pool the far view too): paged_decode_split_kernel on the tensor cores,
// then paged_decode_combine_kernel (its far form,
// paged_decode_combine_far_kernel, under the far view). Grid (B, KV *
// ceil(n_rep / 16), S): a CTA of 4 warps owns up to 16 grouped query heads of
// one kv head (rows past n_rep zero) and split s of the window, blocks [s nbs,
// (s + 1) nbs) of [0, NB) with nbs = ceil(NB / S). S comes from the shapes and
// the SM count alone (paged_attention.split_count), never from seq_lens or
// window_base, so one shape always launches one grid. The split's rows are
// walked in 64-key tiles from its first row; with skip_extent only the tiles
// that meet ref.active_block_extent's blocks. Each key row is gathered through
// block_table (any BT) with 16-byte cp.async copies into a 2-stage ring; only
// rows at window positions (pos >= 0, pos > t - W, pos < t) are read, every
// other row is zero-filled and masked, decided from positions alone, so a tile
// outside the extent is a bitwise no-op and skip on == off bitwise. Layout:
// the query rows sit on the 16-row side of mma.m16n8k16 (S = Q.K^T, 5 of 16
// rows used at qwen's n_rep 5): each warp takes 16 keys of the tile, its score
// fragment is the A fragment of P.V with no shuffle, and decode is bound by
// bytes, so the idle rows cost nothing that shows. A narrow pool stages raw
// codes and widens them to bf16 in shared memory (exact); k_scale multiplies
// the score columns, v_scale p's columns, in f32.
//
// Precision. The split kernel stays as close to the plain version as the
// f32 CUDA-core kernel it replaces:
//   * the softmax follows the plain version's arithmetic: scores scaled by
//     1 / sqrt(hd), then p = expf(s - m) with the accurate expf, m a
//     running max;
//   * P.V takes p as a sum of bf16 parts (two for a bf16 pool, three for a
//     narrow one; one mma each), so p keeps ~16 / ~24 bits; the scores'
//     products are exact (bytes bound the kernel; the extra mma hide
//     behind the loads);
//   * each mma starts from a zero accumulator and its result is added to
//     the running scores or output in f32: the tensor cores truncate as
//     they accumulate, and chained over a split's k-steps and p's parts
//     that rounded 53-55% of the outputs apart from the plain version's
//     toward zero (PERF.md, PR 28).
// After the walk the 4 warps' (m, l, acc) are folded in the order 0..3 and
// written as the split's f32 partial. The combine (one warp per (slot,
// query head)) folds the S partials in the order 0..S-1, then the current
// token once, last, and writes acc / max(l, 1e-20) in bf16; a retired slot
// writes zeros. No atomics: run == run bitwise.
//
// The far view adds no work to the split CTAs (same grid, same S, same
// workspace). Its far combine takes one CTA per (slot, kv head), one warp
// per query head of the group (n_rep <= 32): each warp scores the CAP far
// entries against its query with f32 FMAs, takes its max over those
// scores, the splits' m and the current token, and folds the far entries
// first (c = 0..CAP-1), then the splits and the current token as the
// combine does, so a far view whose entries are all masked gives the
// no-far output bitwise. far_util[b, g, c] is summed over the group's
// query heads in the order 0..n_rep-1 in shared memory (no atomics).
//
// Design of paged_decode_kernel (f32 q, with or without the far view; the
// pool-only form).
// One thread block per (slot, kv head); a runtime loop inside the
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
// 3.35 TB/s; narrow pools halve it. These kernels are simple, not
// fast: 64 thread blocks fill half the card and the dots run on CUDA
// cores (no wgmma/TMA, no split-KV), which is what holds them back, not
// their loads; the double-buffered kernel hides an 8-16 KiB block load at
// most. The tiles stay f32 in shared memory whatever the pool's type. The
// split-KV kernel answers both: at that shape S = 5 gives 320 CTAs (2.4 an
// SM), and its dots run on the tensor cores.
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"
#include "online_softmax.cuh"

namespace {

// T: q / cur / out / far element; TP: the pool's element (T, or a narrow
// code of the quantized tier). kCur: the engine's form (the current token
// from cur_k / cur_v); without it the pool-only form.
template <typename T, typename TP, bool kFar, bool kCur>
__global__ void paged_decode_kernel(
    const T* __restrict__ q,            // (B, H, hd)
    const TP* __restrict__ pool_k,      // (P, BT, KV, hd)
    const TP* __restrict__ pool_v,      // (P, BT, KV, hd)
    const int* __restrict__ block_table,  // (B, NB)
    const int* __restrict__ window_base,  // (B,)
    const int* __restrict__ seq_lens,     // (B,)  position of the current token
    const int* __restrict__ slot_active,  // (B,)
    const T* __restrict__ cur_k,        // (B, KV, hd), null in the pool-only form
    const T* __restrict__ cur_v,        // (B, KV, hd), null in the pool-only form
    const float* __restrict__ k_scale,  // (P, KV), quantized pools only
    const float* __restrict__ v_scale,  // (P, KV), quantized pools only
    const T* __restrict__ far_k,        // (B, MAXC, KV, hd) or null
    const T* __restrict__ far_v,        // (B, MAXC, KV, hd) or null
    const int* __restrict__ far_table,  // (B, CAP)
    const int* __restrict__ far_valid,  // (B, CAP)
    T* __restrict__ out,                // (B, H, hd)
    float* __restrict__ far_util,       // (B, KV, CAP) or null
    int H, int KV, int hd, int BT, int NB, int MAXC, int CAP,
    int near_window, int skip_extent, float scale) {
  constexpr bool kQuant = !std::is_same<T, TP>::value;
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
    kvrm::online_step(tile, BT, scale, [&](int, int j) {
      const int pos = pos0 + j;
      return (kCur ? pos < t : pos <= t) && pos > t - near_window && pos >= 0;
    });
  }

  if constexpr (kCur) {
    // the current token: one last online step (valid for an active slot)
    const size_t cb = ((size_t)b * KV + g) * hd;
    for (int d = tid; d < hd; d += nthr) {
      tile.Ks[d] = kvrm::to_f32(cur_k[cb + d]);
      tile.Vs[d] = kvrm::to_f32(cur_v[cb + d]);
    }
    __syncthreads();
    kvrm::online_step(tile, 1, scale, [](int, int) { return true; });
  }

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

// ---------------------------------------------------------------------------
// the engine form with bf16 q: split-KV on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kSplitKeys = 64;   // keys per K/V tile, 16 per warp
constexpr int kSplitWarps = 4;
constexpr int kSplitRows = 16;   // query rows of a CTA (grouped heads, padded)
constexpr int kSplitPad = 8;     // bf16 elements added to each staged row
constexpr int kMergePad = 4;     // f32 elements added to each merge row

// Q tile, then the larger of: the K/V staging (bf16 pool: 2 stages of K
// and of V; narrow pool: one bf16 K/V tile, 2 stages of raw codes and of
// each key row's k and v scale) and the warps' partials for the merge.
__host__ __device__ constexpr size_t split_stage_bytes(int hd, bool quant) {
  return quant ? (size_t)2 * kSplitKeys * (hd + kSplitPad) * 2 +
                     (size_t)4 * kSplitKeys * hd +
                     (size_t)4 * kSplitKeys * sizeof(float)
               : (size_t)4 * kSplitKeys * (hd + kSplitPad) * 2;
}
__host__ __device__ constexpr size_t split_merge_bytes(int hd) {
  return (size_t)kSplitWarps * kSplitRows * (hd + kMergePad + 2) *
         sizeof(float);
}
__host__ __device__ constexpr size_t split_smem_bytes(int hd, bool quant) {
  return (size_t)kSplitRows * (hd + kSplitPad) * 2 +
         (split_stage_bytes(hd, quant) > split_merge_bytes(hd)
              ? split_stage_bytes(hd, quant)
              : split_merge_bytes(hd));
}

// Two narrow codes (x's low 16 bits, the first code in the low byte) ->
// two bf16 in one register, exactly (chunked_prefill.cu's widening).
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

// One CTA: slot b, up to 16 grouped query heads of kv head g, window blocks
// [s nbs, (s + 1) nbs) of [0, NB). Writes that split's f32 partial (m, l,
// acc) of each of its query rows; the combine kernel folds them.
template <int HD, typename TP>
__global__ void __launch_bounds__(kSplitWarps * 32) paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, H, HD)
    const TP* __restrict__ pool_k,        // (P, BT, KV, HD)
    const TP* __restrict__ pool_v,        // (P, BT, KV, HD)
    const int* __restrict__ block_table,  // (B, NB)
    const int* __restrict__ window_base,  // (B,)
    const int* __restrict__ seq_lens,     // (B,)  position of the current token
    const int* __restrict__ slot_active,  // (B,)
    const float* __restrict__ k_scale,    // (P, KV), narrow pools only
    const float* __restrict__ v_scale,    // (P, KV), narrow pools only
    float* __restrict__ work,  // m (B, H, S), l (B, H, S), acc (B, H, S, HD)
    int H, int KV, int BT, int NB, int nbs, int near_window, int skip_extent,
    float scale) {
  namespace mm = kvrm::mma;
  constexpr bool kQuant = !std::is_same<TP, __nv_bfloat16>::value;
  constexpr int LD = HD + kSplitPad;   // staged bf16 row stride (elements)
  constexpr int LM = HD + kMergePad;   // merge row stride (floats)
  constexpr int CPR = HD / 8;          // 16-byte chunks per bf16 row
  constexpr int CPRQ = HD / 16;        // 16-byte chunks per row of codes
  constexpr int KC = HD / 16;          // k-steps of Q.K^T; d pairs of P.V
  constexpr int NTHR = kSplitWarps * 32;
  constexpr int kStages = kQuant ? 1 : 2;   // bf16 K/V tiles
  // bf16 parts of p in P.V: ~16 bits for a bf16 pool (the plain version
  // rounds p to bf16 there), ~24 for a narrow pool (it keeps p in f32)
  constexpr int kParts = kQuant ? 3 : 2;
  static_assert(kSplitKeys * CPR % NTHR == 0, "whole passes over a tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kSplitRows * LD;          // kStages x 64 x LD
  __nv_bfloat16* Vs = Ks + kStages * kSplitKeys * LD;
  // narrow pool only: 2 stages of raw codes (64 x HD) and of scales
  TP* Kr = reinterpret_cast<TP*>(Vs + kStages * kSplitKeys * LD);
  TP* Vr = Kr + 2 * kSplitKeys * HD;
  float* Ksc = reinterpret_cast<float*>(Vr + 2 * kSplitKeys * HD);
  float* Vsc = Ksc + 2 * kSplitKeys;

  const int b = blockIdx.x, s = blockIdx.z;
  const int B = gridDim.x, S = gridDim.z;
  const int n_rep = H / KV;
  const int QG = (n_rep + kSplitRows - 1) / kSplitRows;
  const int g = blockIdx.y / QG;
  // the query head of this CTA's row 0
  const int h0 = g * n_rep + (blockIdx.y - g * QG) * kSplitRows;
  const int nq = min(kSplitRows, (g + 1) * n_rep - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (!(slot_active[b] > 0)) return;  // the combine writes the zeros
  const int wb = window_base[b], t = seq_lens[b];

  // this split's window rows [i_lo, i_hi) (row idx at position wb + idx),
  // and the rows holding keys of the window: pos >= 0, pos > t - W,
  // pos < t: [f_lo, f_hi). Every other row is zero-filled, never read
  const int i_lo = min(s * nbs, NB) * BT, i_hi = min((s + 1) * nbs, NB) * BT;
  const int f_lo = max(i_lo, max(0, t + 1 - near_window) - wb);
  const int f_hi = min(i_hi, t - wb);
  // 64-row tiles from i_lo; with skip_extent only those that meet
  // ref.active_block_extent's blocks. Tiles outside it hold no key of the
  // window, so they leave (m, l, acc) as they were: skip on == off bitwise
  int k_lo = 0, k_hi = (i_hi - i_lo + kSplitKeys - 1) / kSplitKeys;
  if (skip_extent) {
    const int lo_pos = max(0, t + 1 - near_window);
    const int lo = min(max(kvrm::floordiv(lo_pos - wb, BT), 0), NB);
    const int hi = max(min(max(kvrm::floordiv(t - wb, BT) + 1, 0), NB), lo);
    const int e_lo = max(lo * BT, i_lo), e_hi = min(hi * BT, i_hi);
    k_lo = e_hi > e_lo ? (e_lo - i_lo) / kSplitKeys : 0;
    k_hi = e_hi > e_lo ? (e_hi - i_lo + kSplitKeys - 1) / kSplitKeys : 0;
  }
  const int n_tiles = k_hi - k_lo;

  const size_t rstride = (size_t)KV * HD;
  const int* tbl = block_table + (size_t)b * NB;
  // pool offset (elements) of window row idx, column d of kv head g
  auto pool_off = [&](int idx, int d) {
    const int blk = __ldg(tbl + idx / BT);
    return ((size_t)blk * BT + idx % BT) * rstride + (size_t)g * HD + d;
  };

  // Q rows past nq are zero-filled (their results are never stored)
  const __nv_bfloat16* qb = q + ((size_t)b * H + h0) * HD;
  for (int c = tid; c < kSplitRows * CPR; c += NTHR) {
    const int m = c / CPR, d = (c - m * CPR) * 8;
    const bool ok = m < nq;
    mm::cp_async16(Qs + m * LD + d, ok ? qb + (size_t)m * HD + d : q, ok);
  }
  mm::cp_async_commit();  // Q
  if (n_tiles > 0) {      // tile k_lo into stage 0 (inline, as below)
    const int i0 = i_lo + k_lo * kSplitKeys;
    if constexpr (!kQuant) {
#pragma unroll
      for (int i = 0; i < kSplitKeys * CPR / NTHR; ++i) {
        const int c = tid + i * NTHR, jj = c / CPR, d = (c - jj * CPR) * 8;
        const int idx = i0 + jj;
        const bool ok = idx >= f_lo && idx < f_hi;
        const size_t o = ok ? pool_off(idx, d) : 0;
        mm::cp_async16(Ks + jj * LD + d, pool_k + o, ok);
        mm::cp_async16(Vs + jj * LD + d, pool_v + o, ok);
      }
    } else {
      for (int c = tid; c < kSplitKeys * CPRQ; c += NTHR) {
        const int jj = c / CPRQ, d = (c - jj * CPRQ) * 16;
        const int idx = i0 + jj;
        const bool ok = idx >= f_lo && idx < f_hi;
        const size_t o = ok ? pool_off(idx, d) : 0;
        mm::cp_async16(Kr + jj * HD + d, pool_k + o, ok);
        mm::cp_async16(Vr + jj * HD + d, pool_v + o, ok);
      }
      if (tid < kSplitKeys) {
        const int idx = i0 + tid;
        const bool ok = idx >= f_lo && idx < f_hi;
        const size_t o = ok ? (size_t)__ldg(tbl + idx / BT) * KV + g : 0;
        mm::cp_async4(Ksc + tid, k_scale + o, ok);
        mm::cp_async4(Vsc + tid, v_scale + o, ok);
      }
    }
  }
  mm::cp_async_commit();  // tile k_lo (empty when the split has none)

  // this thread's C rows qr, qr + 8 and key columns qc2, qc2 + 1 of each
  // 8-key tile; ldmatrix row addresses of this lane, as in prefill_flash.cu
  const int qr = lane >> 2, qc2 = (lane & 3) * 2;
  const __nv_bfloat16* q_lane = Qs + (lane & 15) * LD + (lane >> 4) * 8;
  const int k_lane = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  float acc[2 * KC][4];
#pragma unroll
  for (int dt = 0; dt < 2 * KC; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_run[2] = {kvrm::kNegInit, kvrm::kNegInit};
  float l_run[2] = {0.f, 0.f};

  constexpr bool kQReg = HD <= 128;
  uint32_t qf[kQReg ? KC : 1][4];
  if constexpr (kQReg) {
    if (n_tiles > 0) {
      mm::cp_async_wait<1>();  // Q has landed (tile k_lo may be in flight)
      __syncthreads();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mm::ldmatrix_x4(qf[kc], q_lane + kc * 16);
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {  // tile it + 1 into stage (it + 1) & 1
      const int st = (it + 1) & 1;
      const int i0 = i_lo + (k_lo + it + 1) * kSplitKeys;
      if constexpr (!kQuant) {
#pragma unroll
        for (int i = 0; i < kSplitKeys * CPR / NTHR; ++i) {
          const int c = tid + i * NTHR, jj = c / CPR, d = (c - jj * CPR) * 8;
          const int idx = i0 + jj;
          const bool ok = idx >= f_lo && idx < f_hi;
          const size_t o = ok ? pool_off(idx, d) : 0;
          const int so = (st * kSplitKeys + jj) * LD + d;
          mm::cp_async16(Ks + so, pool_k + o, ok);
          mm::cp_async16(Vs + so, pool_v + o, ok);
        }
      } else {
        for (int c = tid; c < kSplitKeys * CPRQ; c += NTHR) {
          const int jj = c / CPRQ, d = (c - jj * CPRQ) * 16;
          const int idx = i0 + jj;
          const bool ok = idx >= f_lo && idx < f_hi;
          const size_t o = ok ? pool_off(idx, d) : 0;
          const int so = (st * kSplitKeys + jj) * HD + d;
          mm::cp_async16(Kr + so, pool_k + o, ok);
          mm::cp_async16(Vr + so, pool_v + o, ok);
        }
        if (tid < kSplitKeys) {
          const int idx = i0 + tid;
          const bool ok = idx >= f_lo && idx < f_hi;
          const size_t o = ok ? (size_t)__ldg(tbl + idx / BT) * KV + g : 0;
          mm::cp_async4(Ksc + st * kSplitKeys + tid, k_scale + o, ok);
          mm::cp_async4(Vsc + st * kSplitKeys + tid, v_scale + o, ok);
        }
      }
    }
    mm::cp_async_commit();    // (empty past the last tile)
    mm::cp_async_wait<1>();   // this thread's copies of tile it have landed
    __syncthreads();          // ... and every thread's
    if constexpr (kQuant) {
      // widen stage it & 1's codes into the bf16 tile: 16 codes a chunk
      const TP* kr = Kr + (it & 1) * kSplitKeys * HD;
      const TP* vr = Vr + (it & 1) * kSplitKeys * HD;
      for (int c = tid; c < kSplitKeys * CPRQ; c += NTHR) {
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
          uint4* dst = reinterpret_cast<uint4*>((kv ? Vs : Ks) + jj * LD + d);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
      }
      __syncthreads();
    }
    const int stage = kQuant ? 0 : (it & 1) * kSplitKeys * LD;
    const __nv_bfloat16* ks = Ks + stage + warp * 16 * LD;   // this warp's
    const __nv_bfloat16* vs = Vs + stage + warp * 16 * LD;   // 16 keys

    // S = Q . K^T: 16 rows x 16 keys per warp
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      if constexpr (kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
      } else {
        mm::ldmatrix_x4(a, q_lane + kc * 16);
      }
      uint32_t bk[4];
      mm::ldmatrix_x4(bk, ks + k_lane + kc * 16);
      // each k-step from a zero accumulator, added in f32 (round to
      // nearest): the tensor cores' own accumulation truncates
      float d[2][4] = {};
      mm::mma_bf16(d[0], a, bk[0], bk[1]);
      mm::mma_bf16(d[1], a, bk[2], bk[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] += d[nt][e];
    }
    // tile-relative key column of sc[nt][e]: warp * 16 + nt * 8 + qc2 + (e & 1)
    const int key0 = (it & 1) * kSplitKeys + warp * 16 + qc2;  // in Ksc / Vsc
    if constexpr (kQuant) {  // k_scale of each key's block, in f32
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 k2 = *reinterpret_cast<const float2*>(Ksc + key0 + nt * 8);
        sc[nt][0] *= k2.x;
        sc[nt][1] *= k2.y;
        sc[nt][2] *= k2.x;
        sc[nt][3] *= k2.y;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)   // scaled scores, as the plain version's
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] *= scale;
    // keys outside [f_lo, f_hi) are masked (the same for every row)
    const int idx0 = i_lo + (k_lo + it) * kSplitKeys + warp * 16;
    if (idx0 < f_lo || idx0 + 16 > f_hi) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = idx0 + nt * 8 + qc2 + (e & 1);
          if (!(idx >= f_lo && idx < f_hi)) sc[nt][e] = -INFINITY;
        }
    }

    float corr[2];
    mm::online_softmax_step_exp<2>(sc, m_run, l_run, corr);
#pragma unroll
    for (int dt = 0; dt < 2 * KC; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
    if constexpr (kQuant) {  // v_scale of each key's block, in f32
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 v2 = *reinterpret_cast<const float2*>(Vsc + key0 + nt * 8);
        sc[nt][0] *= v2.x;
        sc[nt][1] *= v2.y;
        sc[nt][2] *= v2.x;
        sc[nt][3] *= v2.y;
      }
    }

    // acc += P . V, p as kParts bf16 A fragments straight from sc
    uint32_t pp[kParts][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // A register e: sc[e >> 1][(e & 1) * 2 ..]
      uint32_t parts[kParts];
      mm::pack_bf16_parts<kParts>(sc[e >> 1][(e & 1) * 2],
                                  sc[e >> 1][(e & 1) * 2 + 1], parts);
#pragma unroll
      for (int k = 0; k < kParts; ++k) pp[k][e] = parts[k];
    }
#pragma unroll
    for (int dp = 0; dp < KC; ++dp) {
      uint32_t bv[4];
      mm::ldmatrix_x4_trans(bv, vs + v_lane + dp * 16);
      // the parts from the smallest, into a zero accumulator, then added
      // to acc in f32 (round to nearest), as for the scores
      float d[2][4] = {};
#pragma unroll
      for (int k = kParts - 1; k >= 0; --k) {
        mm::mma_bf16(d[0], pp[k], bv[0], bv[1]);
        mm::mma_bf16(d[1], pp[k], bv[2], bv[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * dp][e] += d[0][e];
        acc[2 * dp + 1][e] += d[1][e];
      }
    }
    __syncthreads();  // the stage (the bf16 tile) is refilled next
  }
  mm::cp_async_wait<0>();  // (Q, when the split had no tile)
  __syncthreads();

  // the row sums: the quad's four shares
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  // each warp's (m, l, acc) into shared memory (over the staging), then
  // the warps folded in the order 0..3
  float* Mw = reinterpret_cast<float*>(Ks);           // kSplitWarps x 16
  float* Lw = Mw + kSplitWarps * kSplitRows;          // kSplitWarps x 16
  float* Aw = Lw + kSplitWarps * kSplitRows;          // kSplitWarps x 16 x LM
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * kSplitRows + qr + 8 * i;
    if ((lane & 3) == 0) {
      Mw[r] = m_run[i];
      Lw[r] = l_run[i];
    }
#pragma unroll
    for (int dt = 0; dt < 2 * KC; ++dt)
      *reinterpret_cast<float2*>(Aw + r * LM + dt * 8 + qc2) =
          make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
  __syncthreads();
  float* wm = work;
  float* wl = work + (size_t)B * H * S;
  float* wa = work + (size_t)2 * B * H * S;
  for (int e = tid; e < nq * HD; e += NTHR) {
    const int r = e / HD, d = e - r * HD;
    float mx = Mw[r];
#pragma unroll
    for (int w = 1; w < kSplitWarps; ++w)
      mx = fmaxf(mx, Mw[w * kSplitRows + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const int rw = w * kSplitRows + r;
      const float c = expf(Mw[rw] - mx);
      l += Lw[rw] * c;
      a += Aw[rw * LM + d] * c;
    }
    const size_t row = ((size_t)b * H + h0 + r) * S + s;
    wa[row * HD + d] = a;
    if (d == 0) {
      wm[row] = mx;
      wl[row] = l;
    }
  }
}

// One warp per (slot, query head): the S partials folded in the order
// 0..S-1, then the current token (q . cur_k, p times cur_v) once, last;
// out = acc / max(l, 1e-20) in bf16. A retired slot writes zeros. Every
// load of a pass is issued before its first use (the partials 8 splits at
// a time), so a call waits on memory about twice, not once per split.
__global__ void __launch_bounds__(128) paged_decode_combine_kernel(
    const float* __restrict__ work,         // as paged_decode_split_kernel's
    const __nv_bfloat16* __restrict__ q,      // (B, H, hd)
    const __nv_bfloat16* __restrict__ cur_k,  // (B, KV, hd)
    const __nv_bfloat16* __restrict__ cur_v,  // (B, KV, hd)
    const int* __restrict__ slot_active,      // (B,)
    __nv_bfloat16* __restrict__ out,          // (B, H, hd)
    int B, int H, int KV, int hd, int S, float scale) {
  constexpr int kPer = 256 / 32;  // hd <= 256: elements per lane
  constexpr int kBatch = 8;       // splits whose partials load together
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= B * H) return;
  const int b = row / H, g = (row - b * H) / (H / KV);
  const int nj = (hd - lane + 31) / 32;  // this lane's columns lane + 32 j
  const __nv_bfloat16* qr = q + (size_t)row * hd;
  const __nv_bfloat16* ck = cur_k + ((size_t)b * KV + g) * hd;
  const __nv_bfloat16* cv = cur_v + ((size_t)b * KV + g) * hd;
  const float* wm = work + (size_t)row * S;
  const float* wl = work + (size_t)B * H * S + (size_t)row * S;
  const float* wa = work + (size_t)2 * B * H * S + (size_t)row * S * hd;
  const bool active = slot_active[b] > 0;
  float qv[kPer], kv[kPer], vv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool ok = j < nj;
    qv[j] = ok ? __bfloat162float(qr[lane + 32 * j]) : 0.f;
    kv[j] = ok ? __bfloat162float(ck[lane + 32 * j]) : 0.f;
    vv[j] = ok ? __bfloat162float(cv[lane + 32 * j]) : 0.f;
  }
  // lane s holds split s's m and l (S <= 32; more in further passes)
  const float m0 = lane < S ? wm[lane] : -INFINITY;
  const float l0 = lane < S ? wl[lane] : 0.f;
  __nv_bfloat16* o = out + (size_t)row * hd;
  if (!active) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (j < nj) o[lane + 32 * j] = __float2bfloat16(0.f);
    return;
  }
  // the current token's scaled score, the same in every lane (xor
  // butterfly)
  float sc = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) sc = fmaf(qv[j], kv[j], sc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sc += __shfl_xor_sync(0xffffffffu, sc, off);
  sc *= scale;
  // the max over the splits' m and the current token's score (any order)
  float mx = fmaxf(sc, m0);
  for (int s = 32 + lane; s < S; s += 32) mx = fmaxf(mx, wm[s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float l = 0.f, acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < S; s0 += kBatch) {
    // this batch's partials, all loads first
    float a[kBatch][kPer];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        a[k][j] = (s0 + k < S && j < nj)
                      ? wa[(size_t)(s0 + k) * hd + lane + 32 * j] : 0.f;
    const int src = s0 & 31;  // lane of split s0 in this pass's m, l
    float ms = m0, ls = l0;
    if (s0 >= 32) {
      ms = s0 + lane - src < S && lane >= src ? wm[s0 - src + lane] : 0.f;
      ls = s0 + lane - src < S && lane >= src ? wl[s0 - src + lane] : 0.f;
    }
    const float cs = expf(ms - mx);
    // splits s0 .. s0 + 7 in order, the same in every lane
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (s0 + k >= S) break;
      const float c = __shfl_sync(0xffffffffu, cs, src + k);
      l = fmaf(__shfl_sync(0xffffffffu, ls, src + k), c, l);
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] = fmaf(a[k][j], c, acc[j]);
    }
  }
  const float pc = expf(sc - mx);
  l += pc;
  const float den = fmaxf(l, 1e-20f);
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (j < nj)
      o[lane + 32 * j] = __float2bfloat16(fmaf(pc, vv[j], acc[j]) / den);
}

cudaError_t launch_combine(const void* work, const void* q, const void* cur_k,
                           const void* cur_v, const void* slot_active,
                           void* out, int B, int H, int KV, int hd, int S,
                           float scale, void* stream) {
  if (hd > 256 || S < 1) return cudaErrorInvalidValue;
  paged_decode_combine_kernel<<<(B * H + 3) / 4, 128, 0,
                                (cudaStream_t)stream>>>(
      (const float*)work, (const __nv_bfloat16*)q,
      (const __nv_bfloat16*)cur_k, (const __nv_bfloat16*)cur_v,
      (const int*)slot_active, (__nv_bfloat16*)out, B, H, KV, hd, S, scale);
  return cudaGetLastError();
}

// The far form of the combine (the far view, bf16 pool): one CTA per (slot,
// kv head), one warp per query head of its group (n_rep <= 32). The CTA
// stages the CAP far rows selected by far_table[b] (K and V of kv head g;
// a masked entry zero-filled, never read) in shared memory with 16-byte
// cp.async copies (rows padded by 16 bytes), while each warp loads what the
// combine loads, its first batch of split partials included, and puts its
// query in shared memory as f32. Each warp then scores the far entries
// against its query, lane c entry c, with f32 FMAs (q . k over hd in four
// interleaved sums, times scale; -inf where far_valid <= 0), takes its max
// over those scores, the splits' m and the current token, and folds the far
// entries first, in the order c = 0..CAP-1 (p = expf(s - mx)), then splits
// 0..S-1 and the current token once, last, with
// paged_decode_combine_kernel's statements. A masked entry has p = 0 and a
// zero-filled row, so it adds exactly nothing (x + 0 = x, fmaf(0, 0, x) =
// x): with every entry masked the output is the combine's, bitwise.
// far_util[b, g, c] = entry c's p / max(l, 1e-20) summed over the warps r
// = 0..n_rep-1 in that order; a retired slot writes zeros. No atomics: run
// == run bitwise.
// kWarps bounds the CTA's warps (n_rep <= kWarps), and so the registers a
// thread may hold.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_combine_far_kernel(
    const float* __restrict__ work,           // as paged_decode_split_kernel's
    const __nv_bfloat16* __restrict__ q,      // (B, H, hd)
    const __nv_bfloat16* __restrict__ cur_k,  // (B, KV, hd)
    const __nv_bfloat16* __restrict__ cur_v,  // (B, KV, hd)
    const int* __restrict__ slot_active,      // (B,)
    const __nv_bfloat16* __restrict__ far_k,  // (B, MAXC, KV, hd)
    const __nv_bfloat16* __restrict__ far_v,  // (B, MAXC, KV, hd)
    const int* __restrict__ far_table,        // (B, CAP)
    const int* __restrict__ far_valid,        // (B, CAP)
    __nv_bfloat16* __restrict__ out,          // (B, H, hd)
    float* __restrict__ far_util,             // (B, KV, CAP)
    int B, int H, int KV, int hd, int S, int MAXC, int CAP, float scale) {
  namespace mm = kvrm::mma;
  constexpr int kPer = 256 / 32;  // hd <= 256: elements per lane
  constexpr int kBatch = 8;       // splits whose partials load together
  extern __shared__ __align__(16) unsigned char smem_far[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int n_rep = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = b * H + g * n_rep + warp;
  const int ldf = hd + 8;  // staged far row stride (bf16), 16-byte rows
  __nv_bfloat16* Fk = reinterpret_cast<__nv_bfloat16*>(smem_far);  // CAP rows
  __nv_bfloat16* Fv = Fk + (size_t)CAP * ldf;                      // CAP rows
  float* Qf = reinterpret_cast<float*>(Fv + (size_t)CAP * ldf);  // n_rep x hd
  float* Fs = Qf + (size_t)n_rep * hd;                           // n_rep x CAP
  float* qs = Qf + (size_t)warp * hd;   // this warp's query, f32
  float* fs = Fs + (size_t)warp * CAP;  // this warp's far scores, then p
  float* util = far_util + ((size_t)b * KV + g) * CAP;
  const int* ftab = far_table + (size_t)b * CAP;
  const int* fval = far_valid + (size_t)b * CAP;
  const int nj = (hd - lane + 31) / 32;  // this lane's columns lane + 32 j
  __nv_bfloat16* o = out + (size_t)row * hd;
  const bool active = slot_active[b] > 0;
  // the far rows of kv head g, 16 bytes a copy (hd % 8 == 0)
  const int cpr = hd / 8;
  for (int c = threadIdx.x; c < CAP * cpr; c += blockDim.x) {
    const int e = c / cpr, d = (c - e * cpr) * 8;
    const bool ok = active && fval[e] > 0;
    const int idx = min(max(ftab[e], 0), MAXC - 1);
    const size_t off = ok ? (((size_t)b * MAXC + idx) * KV + g) * hd + d : 0;
    mm::cp_async16(Fk + (size_t)e * ldf + d, far_k + off, ok);
    mm::cp_async16(Fv + (size_t)e * ldf + d, far_v + off, ok);
  }
  mm::cp_async_commit();
  if (!active) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (j < nj) o[lane + 32 * j] = __float2bfloat16(0.f);
    if (warp == 0)
      for (int c = lane; c < CAP; c += 32) util[c] = 0.f;
    mm::cp_async_wait<0>();  // (every copy zero-filled: nothing in flight)
    return;
  }

  const __nv_bfloat16* qr = q + (size_t)row * hd;
  const __nv_bfloat16* ck = cur_k + ((size_t)b * KV + g) * hd;
  const __nv_bfloat16* cv = cur_v + ((size_t)b * KV + g) * hd;
  const float* wm = work + (size_t)row * S;
  const float* wl = work + (size_t)B * H * S + (size_t)row * S;
  const float* wa = work + (size_t)2 * B * H * S + (size_t)row * S * hd;
  float qv[kPer], kv[kPer], vv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool ok = j < nj;
    qv[j] = ok ? __bfloat162float(qr[lane + 32 * j]) : 0.f;
    kv[j] = ok ? __bfloat162float(ck[lane + 32 * j]) : 0.f;
    vv[j] = ok ? __bfloat162float(cv[lane + 32 * j]) : 0.f;
    if (ok) qs[lane + 32 * j] = qv[j];
  }
  // lane s holds split s's m and l (S <= 32; more in further passes)
  const float m0 = lane < S ? wm[lane] : -INFINITY;
  const float l0 = lane < S ? wl[lane] : 0.f;
  // the first batch's partials, in flight with the far rows
  float a[kBatch][kPer];
#pragma unroll
  for (int k = 0; k < kBatch; ++k)
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      a[k][j] = (k < S && j < nj) ? wa[(size_t)k * hd + lane + 32 * j] : 0.f;
  // the current token's scaled score, the same in every lane (xor
  // butterfly)
  float sc = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) sc = fmaf(qv[j], kv[j], sc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sc += __shfl_xor_sync(0xffffffffu, sc, off);
  sc *= scale;
  // the max over the splits' m and the current token's score (any order)
  float mx = fmaxf(sc, m0);
  for (int s = 32 + lane; s < S; s += 32) mx = fmaxf(mx, wm[s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

  mm::cp_async_wait<0>();
  __syncthreads();
  // the far scores, lane c entry c (8 columns a step); then the max over
  // them too
  for (int e = lane; e < CAP; e += 32) {
    const __nv_bfloat16* fk = Fk + (size_t)e * ldf;
    float d4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < hd; d += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(fk + d);
      const float4 qa = *reinterpret_cast<const float4*>(qs + d);
      const float4 qb = *reinterpret_cast<const float4*>(qs + d + 4);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      const float qq[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 k2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        d4[i] = fmaf(qq[2 * i], k2.x, d4[i]);
        d4[i] = fmaf(qq[2 * i + 1], k2.y, d4[i]);
      }
    }
    float s = ((d4[0] + d4[1]) + (d4[2] + d4[3])) * scale;
    if (!(fval[e] > 0)) s = -INFINITY;
    mx = fmaxf(mx, s);
    fs[e] = s;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  for (int e = lane; e < CAP; e += 32) {
    const float s = fs[e];
    fs[e] = s == -INFINITY ? 0.f : expf(s - mx);
  }
  __syncwarp();
  float l = 0.f, acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  // the far entries first, in the order 0..CAP-1 (p and fs kept for
  // far_util)
#pragma unroll 4
  for (int e = 0; e < CAP; ++e) {
    const float p = fs[e];
    l += p;
    const __nv_bfloat16* fv = Fv + (size_t)e * ldf;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (j < nj)
        acc[j] = fmaf(p, __bfloat162float(fv[lane + 32 * j]), acc[j]);
  }
  for (int s0 = 0; s0 < S; s0 += kBatch) {
    if (s0 > 0) {  // this batch's partials, all loads first
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          a[k][j] = (s0 + k < S && j < nj)
                        ? wa[(size_t)(s0 + k) * hd + lane + 32 * j] : 0.f;
    }
    const int src = s0 & 31;  // lane of split s0 in this pass's m, l
    float ms = m0, ls = l0;
    if (s0 >= 32) {
      ms = s0 + lane - src < S && lane >= src ? wm[s0 - src + lane] : 0.f;
      ls = s0 + lane - src < S && lane >= src ? wl[s0 - src + lane] : 0.f;
    }
    const float cs = expf(ms - mx);
    // splits s0 .. s0 + 7 in order, the same in every lane
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (s0 + k >= S) break;
      const float c = __shfl_sync(0xffffffffu, cs, src + k);
      l = fmaf(__shfl_sync(0xffffffffu, ls, src + k), c, l);
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] = fmaf(a[k][j], c, acc[j]);
    }
  }
  const float pc = expf(sc - mx);
  l += pc;
  const float den = fmaxf(l, 1e-20f);
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (j < nj)
      o[lane + 32 * j] = __float2bfloat16(fmaf(pc, vv[j], acc[j]) / den);
  // each far entry's probability for this head (0 when masked), then
  // summed over the group's heads in the order 0..n_rep-1
  __syncwarp();  // (every lane has read fs in the fold)
  for (int e = lane; e < CAP; e += 32) fs[e] = fs[e] / den;
  __syncthreads();
  if (warp == 0)
    for (int c = lane; c < CAP; c += 32) {
      float u = 0.f;
      for (int r = 0; r < n_rep; ++r) u += Fs[(size_t)r * CAP + c];
      util[c] = u;
    }
}

// shared memory of the far combine: the CAP staged K and V rows (bf16,
// padded by 8), the n_rep queries (f32) and the n_rep x CAP far scores
size_t combine_far_smem_bytes(int n_rep, int hd, int CAP) {
  return (size_t)2 * CAP * (hd + 8) * sizeof(__nv_bfloat16) +
         (size_t)n_rep * (hd + CAP) * sizeof(float);
}

// What the far combine takes: up to 32 query heads a kv head (a warp each),
// a far_util, and far rows it can copy 16 bytes at a time (hd % 8 == 0,
// 16-byte aligned far_k / far_v).
bool combine_far_fits(int n_rep, int hd, int MAXC, int CAP,
                      const void* far_k, const void* far_v,
                      const void* far_util) {
  return n_rep <= 32 && hd % 8 == 0 && MAXC >= 1 && CAP >= 0 &&
         far_util != nullptr &&
         reinterpret_cast<uintptr_t>(far_k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(far_v) % 16 == 0;
}

// (launch_split_decode has checked combine_far_fits)
cudaError_t launch_combine_far(const void* work, const void* q,
                               const void* cur_k, const void* cur_v,
                               const void* slot_active, const void* far_k,
                               const void* far_v, const void* far_table,
                               const void* far_valid, void* out,
                               void* far_util, int B, int H, int KV, int hd,
                               int S, int MAXC, int CAP, float scale,
                               void* stream) {
  const int n_rep = H / KV;
  const size_t smem = combine_far_smem_bytes(n_rep, hd, CAP);
  // up to 8 query heads a kv head (qwen2.5-32b's 5 among them) in CTAs of
  // at most 256 threads, whose registers hold a batch of partials unspilled
  auto kernel = n_rep <= 8 ? paged_decode_combine_far_kernel<8>
                           : paged_decode_combine_far_kernel<32>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, KV), n_rep * 32, smem, (cudaStream_t)stream>>>(
      (const float*)work, (const __nv_bfloat16*)q,
      (const __nv_bfloat16*)cur_k, (const __nv_bfloat16*)cur_v,
      (const int*)slot_active, (const __nv_bfloat16*)far_k,
      (const __nv_bfloat16*)far_v, (const int*)far_table,
      (const int*)far_valid, (__nv_bfloat16*)out, (float*)far_util, B, H, KV,
      hd, S, MAXC, CAP, scale);
  return cudaGetLastError();
}

template <int HD, typename TP>
cudaError_t launch_split(const void* q, const void* pool_k,
                         const void* pool_v, const void* block_table,
                         const void* window_base, const void* seq_lens,
                         const void* slot_active, const void* k_scale,
                         const void* v_scale, void* work, int B, int H,
                         int KV, int BT, int NB, int S, int near_window,
                         int skip_extent, float scale, void* stream) {
  constexpr bool kQuant = !std::is_same<TP, __nv_bfloat16>::value;
  const size_t smem = split_smem_bytes(HD, kQuant);
  auto kernel = paged_decode_split_kernel<HD, TP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_rep = H / KV;
  dim3 grid(B, KV * ((n_rep + kSplitRows - 1) / kSplitRows), S);
  kernel<<<grid, kSplitWarps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const TP*)pool_k, (const TP*)pool_v,
      (const int*)block_table, (const int*)window_base, (const int*)seq_lens,
      (const int*)slot_active, (const float*)k_scale, (const float*)v_scale,
      (float*)work, H, KV, BT, NB, (NB + S - 1) / S, near_window,
      skip_extent, scale);
  return cudaGetLastError();
}

// The engine form with bf16 q: the split kernel, one instantiation per hd
// (a multiple of 16 up to 256), then the combine, or with the far view
// (non-null far_k) its far form. S splits of [0, NB) (1 <= S <= NB); work
// holds B H S (hd + 2) f32.
template <typename TP>
int launch_split_decode(const void* q, const void* pool_k, const void* pool_v,
                        const void* block_table, const void* window_base,
                        const void* seq_lens, const void* slot_active,
                        const void* cur_k, const void* cur_v,
                        const void* k_scale, const void* v_scale,
                        const void* far_k, const void* far_v,
                        const void* far_table, const void* far_valid,
                        void* out, void* far_util, void* work, int B, int H,
                        int KV, int hd, int BT, int NB, int MAXC, int CAP,
                        int S, int near_window, int skip_extent, float scale,
                        void* stream) {
  // 16-byte copies: 16-byte aligned q and pools (rows of hd * elem bytes,
  // a multiple of 16 for every hd taken); the far combine's rules checked
  // before the split kernel runs
  if (work == nullptr || S < 1 || S > NB ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pool_k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pool_v) % 16 != 0 ||
      (far_k != nullptr &&
       !combine_far_fits(H / KV, hd, MAXC, CAP, far_k, far_v, far_util)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define KVRM_HD(n)                                                           \
  case n:                                                                    \
    err = launch_split<n, TP>(q, pool_k, pool_v, block_table, window_base,  \
                              seq_lens, slot_active, k_scale, v_scale, work, \
                              B, H, KV, BT, NB, S, near_window, skip_extent, \
                              scale, stream);                                \
    break;
  switch (hd) {
    KVRM_HD(16) KVRM_HD(32) KVRM_HD(48) KVRM_HD(64)
    KVRM_HD(80) KVRM_HD(96) KVRM_HD(112) KVRM_HD(128)
    KVRM_HD(144) KVRM_HD(160) KVRM_HD(176) KVRM_HD(192)
    KVRM_HD(208) KVRM_HD(224) KVRM_HD(240) KVRM_HD(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KVRM_HD
  if (err != cudaSuccess) return (int)err;
  if (far_k != nullptr)
    return (int)launch_combine_far(work, q, cur_k, cur_v, slot_active, far_k,
                                   far_v, far_table, far_valid, out, far_util,
                                   B, H, KV, hd, S, MAXC, CAP, scale, stream);
  return (int)launch_combine(work, q, cur_k, cur_v, slot_active, out, B, H,
                             KV, hd, S, scale, stream);
}

// ---------------------------------------------------------------------------
// the double-buffered kernel (`_decode_kernel_db`)
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, asynchronous, cached in L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one of this thread's commit groups is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One block's raw (BT, hd) K and V rows (pool row stride KV * hd) into a
// stage (row stride hd): 16-byte cp.async copies, or element loads.
template <typename TP, bool kDma>
__device__ __forceinline__ void fetch_block(TP* __restrict__ sk,
                                            TP* __restrict__ sv,
                                            const TP* __restrict__ gk,
                                            const TP* __restrict__ gv,
                                            size_t row_stride, int BT,
                                            int hd) {
  if constexpr (kDma) {
    constexpr int kVec = 16 / sizeof(TP);  // elements per copy
    const int per_row = hd / kVec;
    for (int c = threadIdx.x; c < BT * per_row; c += blockDim.x) {
      const int j = c / per_row, d = (c - j * per_row) * kVec;
      cp_async16(sk + (size_t)j * hd + d, gk + (size_t)j * row_stride + d);
      cp_async16(sv + (size_t)j * hd + d, gv + (size_t)j * row_stride + d);
    }
  } else {
    for (int e = threadIdx.x; e < BT * hd; e += blockDim.x) {
      const int j = e / hd, d = e - j * hd;
      sk[(size_t)j * hd + d] = gk[(size_t)j * row_stride + d];
      sv[(size_t)j * hd + d] = gv[(size_t)j * row_stride + d];
    }
  }
}

// byte offset of the stages in shared memory: after the f32 tile, 16-aligned
__host__ __device__ inline size_t db_stage_offset(int n_rep, int hd, int BT) {
  return (kvrm::tile_floats(n_rep, hd, BT) * sizeof(float) + 15) / 16 * 16;
}

template <typename T, typename TP, bool kDma>
__global__ void paged_decode_db_kernel(
    const T* __restrict__ q,            // (B, H, hd)
    const TP* __restrict__ pool_k,      // (P, BT, KV, hd)
    const TP* __restrict__ pool_v,      // (P, BT, KV, hd)
    const int* __restrict__ block_table,  // (B, NB)
    const int* __restrict__ window_base,  // (B,)
    const int* __restrict__ seq_lens,     // (B,)  position of the current token
    const int* __restrict__ slot_active,  // (B,)
    const float* __restrict__ k_scale,  // (P, KV), quantized pools only
    const float* __restrict__ v_scale,  // (P, KV), quantized pools only
    T* __restrict__ out,                // (B, H, hd)
    int H, int KV, int hd, int BT, int NB, int near_window, int skip_extent,
    float scale) {
  constexpr bool kQuant = !std::is_same<T, TP>::value;
  extern __shared__ __align__(16) unsigned char smem_db[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int n_rep = H / KV;
  const int tid = threadIdx.x, nthr = blockDim.x;
  T* o = out + ((size_t)b * H + (size_t)g * n_rep) * hd;

  if (!(slot_active[b] > 0)) {  // retired slot: the output is zero
    for (int e = tid; e < n_rep * hd; e += nthr) kvrm::store_as(o + e, 0.f);
    return;
  }
  const int wb = window_base[b], t = seq_lens[b];

  kvrm::Tile tile =
      kvrm::carve(reinterpret_cast<float*>(smem_db), n_rep, hd, BT);
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

  // stage s holds K at stage + 2 s n and V at stage + (2 s + 1) n
  TP* stage = reinterpret_cast<TP*>(smem_db + db_stage_offset(n_rep, hd, BT));
  const size_t n = (size_t)BT * hd;
  const size_t row_stride = (size_t)KV * hd;  // one token of the pool
  auto fetch = [&](int i) {
    const int blk = block_table[(size_t)b * NB + i];
    const size_t base = (size_t)blk * BT * row_stride + (size_t)g * hd;
    TP* sk = stage + (size_t)(i & 1) * 2 * n;
    fetch_block<TP, kDma>(sk, sk + n, pool_k + base, pool_v + base,
                          row_stride, BT, hd);
  };
  if (lo < hi) fetch(lo);  // prime
  if constexpr (kDma) cp_async_commit();
  __syncthreads();

  for (int i = lo; i < hi; ++i) {
    // block i+1's fetch goes out before block i is waited on; its stage
    // was last read by block i-1's fill, which the barrier closing that
    // block's online step has retired
    if (i + 1 < hi) fetch(i + 1);
    if constexpr (kDma) {
      cp_async_commit();    // (an empty group past the extent's end)
      cp_async_wait_one();  // this thread's copies of block i have landed
    }
    __syncthreads();        // ... and every thread's
    const int blk = block_table[(size_t)b * NB + i];
    [[maybe_unused]] float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      ks = k_scale[(size_t)blk * KV + g];
      vs = v_scale[(size_t)blk * KV + g];
    }
    // widen the stage into the f32 tile: paged_decode_kernel's
    // expressions, in its order (stage row stride hd), so the same bits
    const TP* sk = stage + (size_t)(i & 1) * 2 * n;
    const TP* sv = sk + n;
    for (int e = tid; e < BT * hd; e += nthr) {
      const int j = e / hd, d = e - j * hd;
      const size_t off = (size_t)j * hd + d;
      if constexpr (kQuant) {
        tile.Ks[(size_t)j * (hd + 1) + d] = kvrm::to_f32(sk[off]) * ks;
        tile.Vs[(size_t)j * hd + d] = kvrm::to_f32(sv[off]) * vs;
      } else {
        tile.Ks[(size_t)j * (hd + 1) + d] = kvrm::to_f32(sk[off]);
        tile.Vs[(size_t)j * hd + d] = kvrm::to_f32(sv[off]);
      }
    }
    __syncthreads();
    const int pos0 = wb + i * BT;
    kvrm::online_step(tile, BT, scale, [&](int, int j) {
      const int pos = pos0 + j;
      return pos <= t && pos > t - near_window && pos >= 0;
    });
  }

  for (int e = tid; e < n_rep * hd; e += nthr) {
    const int r = e / hd;
    kvrm::store_as(o + e, tile.Acc[e] / fmaxf(tile.L[r], 1e-20f));
  }
}

size_t smem_bytes(int n_rep, int hd, int BT, int CAP) {
  return (kvrm::tile_floats(n_rep, hd, BT) + (size_t)n_rep * CAP) *
         sizeof(float);
}

// the f32 tile plus two stages of raw K and V rows (pool_elem bytes each)
size_t db_smem_bytes(int n_rep, int hd, int BT, int pool_elem) {
  return db_stage_offset(n_rep, hd, BT) +
         (size_t)2 * 2 * BT * hd * pool_elem;
}

template <typename K>
cudaError_t fit_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// a quantized pool needs its scales; a same-type pool takes none
template <typename T, typename TP>
bool scales_fit(const void* k_scale, const void* v_scale) {
  constexpr bool kQuant = !std::is_same<T, TP>::value;
  return kQuant ? (k_scale != nullptr && v_scale != nullptr)
                : (k_scale == nullptr && v_scale == nullptr);
}

template <typename T, typename TP>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* block_table, const void* window_base,
           const void* seq_lens, const void* slot_active, const void* cur_k,
           const void* cur_v, const void* k_scale, const void* v_scale,
           const void* far_k, const void* far_v, const void* far_table,
           const void* far_valid, void* out, void* far_util, void* work,
           int B, int H, int KV, int hd, int BT, int NB, int MAXC, int CAP,
           int splits, int near_window, int skip_extent, float scale,
           int threads, void* stream) {
  constexpr bool kQuant = !std::is_same<T, TP>::value;
  const bool far = far_k != nullptr;
  const bool cur = cur_k != nullptr;
  // the far view and the quantized tier are exclusive; the far view and
  // the pool-only form too; cur_k and cur_v go together
  if (!scales_fit<T, TP>(k_scale, v_scale) || (kQuant && far) ||
      (far && !cur) || cur != (cur_v != nullptr))
    return (int)cudaErrorInvalidValue;
  // bf16 q in the engine form, with or without the far view: the split-KV
  // kernel (bf16 q has no far instantiation of paged_decode_kernel)
  constexpr bool kSplit = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (kSplit) {
    if (cur)
      return launch_split_decode<TP>(
          q, pool_k, pool_v, block_table, window_base, seq_lens, slot_active,
          cur_k, cur_v, k_scale, v_scale, far_k, far_v, far_table, far_valid,
          out, far_util, work, B, H, KV, hd, BT, NB, MAXC, CAP, splits,
          near_window, skip_extent, scale, stream);
  }
  const size_t smem = smem_bytes(H / KV, hd, BT, far ? CAP : 0);
  auto kernel = paged_decode_kernel<T, TP, false, false>;  // pool-only form
  if constexpr (!kSplit) {
    // (a quantized pool has no far instantiation: kFar = !kQuant)
    if (cur)
      kernel = far ? paged_decode_kernel<T, TP, !kQuant, true>
                   : paged_decode_kernel<T, TP, false, true>;
  }
  cudaError_t err = fit_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KV);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const TP*)pool_k, (const TP*)pool_v,
      (const int*)block_table, (const int*)window_base, (const int*)seq_lens,
      (const int*)slot_active, (const T*)cur_k, (const T*)cur_v,
      (const float*)k_scale, (const float*)v_scale, (const T*)far_k,
      (const T*)far_v, (const int*)far_table, (const int*)far_valid, (T*)out,
      (float*)far_util, H, KV, hd, BT, NB, MAXC, CAP, near_window,
      skip_extent, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TP>
int launch_db(const void* q, const void* pool_k, const void* pool_v,
              const void* block_table, const void* window_base,
              const void* seq_lens, const void* slot_active,
              const void* k_scale, const void* v_scale, void* out, int B,
              int H, int KV, int hd, int BT, int NB, int near_window,
              int skip_extent, int dma, float scale, int threads,
              void* stream) {
  if (!scales_fit<T, TP>(k_scale, v_scale)) return (int)cudaErrorInvalidValue;
  // 16-byte copies: 16-byte stage rows and pools
  if (dma && ((hd * sizeof(TP)) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(pool_k) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(pool_v) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = db_smem_bytes(H / KV, hd, BT, (int)sizeof(TP));
  auto kernel = dma ? paged_decode_db_kernel<T, TP, true>
                    : paged_decode_db_kernel<T, TP, false>;
  cudaError_t err = fit_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KV);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const TP*)pool_k, (const TP*)pool_v,
      (const int*)block_table, (const int*)window_base, (const int*)seq_lens,
      (const int*)slot_active, (const float*)k_scale, (const float*)v_scale,
      (T*)out, H, KV, hd, BT, NB, near_window, skip_extent, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one launch needs (bytes); the wrapper checks it. CAP is 0
// without the far view.
size_t paged_decode_smem_bytes(int n_rep, int hd, int BT, int CAP) {
  return smem_bytes(n_rep, hd, BT, CAP);
}

// The split-KV kernel's (bf16 q, the engine form), at head size hd, for a
// bf16 (quant 0) or narrow (quant 1) pool.
size_t paged_decode_split_smem_bytes(int hd, int quant) {
  return split_smem_bytes(hd, quant != 0);
}

// Its far combine's (bf16 q with the far view): CAP far entries, n_rep
// query heads a kv head.
size_t paged_decode_combine_far_smem_bytes(int n_rep, int hd, int CAP) {
  return combine_far_smem_bytes(n_rep, hd, CAP);
}

// The double-buffered kernel's: its tile and two stages of pool_elem-byte
// pool elements.
size_t paged_decode_db_smem_bytes(int n_rep, int hd, int BT, int pool_elem) {
  return db_smem_bytes(n_rep, hd, BT, pool_elem);
}

// The split-KV kernel's combine alone, on a workspace its split kernel
// filled (S splits): the wrapper launches it with the split kernel; this
// entry times it on its own.
int paged_decode_combine_bf16(const void* work, const void* q,
                              const void* cur_k, const void* cur_v,
                              const void* slot_active, void* out, int B,
                              int H, int KV, int hd, int S, float scale,
                              void* stream) {
  return (int)launch_combine(work, q, cur_k, cur_v, slot_active, out, B, H,
                             KV, hd, S, scale, stream);
}

// One entry per (q dtype, pool dtype). Null cur_k / cur_v: the pool-only
// form. Null far_k / far_v / far_table / far_valid / far_util: no far view.
// k_scale / v_scale: (P, KV) f32 for a quantized pool, null otherwise.
// bf16 q in the engine form runs the split-KV kernel and its combine (the
// far combine with the far view: n_rep <= 32, 16-byte aligned far_k /
// far_v): work (B H splits (hd + 2) f32) and splits (1..NB, from the
// shapes: paged_attention.split_count); the other forms ignore both.
#define PAGED_DECODE_ENTRY(NAME, T, TP)                                      \
  int NAME(const void* q, const void* pool_k, const void* pool_v,           \
           const void* block_table, const void* window_base,                \
           const void* seq_lens, const void* slot_active, const void* cur_k, \
           const void* cur_v, const void* k_scale, const void* v_scale,     \
           const void* far_k, const void* far_v, const void* far_table,     \
           const void* far_valid, void* out, void* far_util, void* work,    \
           int B, int H, int KV, int hd, int BT, int NB, int MAXC, int CAP, \
           int splits, int near_window, int skip_extent, float scale,       \
           int threads, void* stream) {                                     \
    return launch<T, TP>(q, pool_k, pool_v, block_table, window_base,       \
                         seq_lens, slot_active, cur_k, cur_v, k_scale,      \
                         v_scale, far_k, far_v, far_table, far_valid, out,  \
                         far_util, work, B, H, KV, hd, BT, NB, MAXC, CAP,   \
                         splits, near_window, skip_extent, scale, threads,  \
                         stream);                                           \
  }

PAGED_DECODE_ENTRY(paged_decode_bf16, __nv_bfloat16, __nv_bfloat16)
PAGED_DECODE_ENTRY(paged_decode_f32, float, float)
PAGED_DECODE_ENTRY(paged_decode_bf16_fp8, __nv_bfloat16, __nv_fp8_e4m3)
PAGED_DECODE_ENTRY(paged_decode_bf16_int8, __nv_bfloat16, int8_t)
PAGED_DECODE_ENTRY(paged_decode_f32_fp8, float, __nv_fp8_e4m3)
PAGED_DECODE_ENTRY(paged_decode_f32_int8, float, int8_t)

// The double-buffered kernel, one entry per (q dtype, pool dtype); the
// pool-only form. dma = 0: synchronous loads through the same two stages.
#define PAGED_DECODE_DB_ENTRY(NAME, T, TP)                                   \
  int NAME(const void* q, const void* pool_k, const void* pool_v,           \
           const void* block_table, const void* window_base,                \
           const void* seq_lens, const void* slot_active,                   \
           const void* k_scale, const void* v_scale, void* out, int B,      \
           int H, int KV, int hd, int BT, int NB, int near_window,          \
           int skip_extent, int dma, float scale, int threads,              \
           void* stream) {                                                  \
    return launch_db<T, TP>(q, pool_k, pool_v, block_table, window_base,    \
                            seq_lens, slot_active, k_scale, v_scale, out,   \
                            B, H, KV, hd, BT, NB, near_window, skip_extent, \
                            dma, scale, threads, stream);                   \
  }

PAGED_DECODE_DB_ENTRY(paged_decode_db_bf16, __nv_bfloat16, __nv_bfloat16)
PAGED_DECODE_DB_ENTRY(paged_decode_db_f32, float, float)
PAGED_DECODE_DB_ENTRY(paged_decode_db_bf16_fp8, __nv_bfloat16, __nv_fp8_e4m3)
PAGED_DECODE_DB_ENTRY(paged_decode_db_bf16_int8, __nv_bfloat16, int8_t)
PAGED_DECODE_DB_ENTRY(paged_decode_db_f32_fp8, float, __nv_fp8_e4m3)
PAGED_DECODE_DB_ENTRY(paged_decode_db_f32_int8, float, int8_t)

}  // extern "C"
