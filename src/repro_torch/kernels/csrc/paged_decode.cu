// Paged near-window GQA decode attention for Hopper (sm_90a): two kernels.
//
// paged_decode_kernel replaces the Pallas TPU kernel `_decode_kernel` (with
// its update `_online_block_update`) in src/repro/kernels/paged_attention.py,
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
// 3.35 TB/s; narrow pools halve it. These kernels are simple, not
// fast: 64 thread blocks fill half the card and the dots run on CUDA
// cores (no wgmma/TMA, no split-KV), which is what holds them back, not
// their loads; the double-buffered kernel hides an 8-16 KiB block load at
// most. The tiles stay f32 in shared memory whatever the pool's type.
#include <stdint.h>

#include <type_traits>

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
           const void* far_valid, void* out, void* far_util, int B, int H,
           int KV, int hd, int BT, int NB, int MAXC, int CAP,
           int near_window, int skip_extent, float scale, int threads,
           void* stream) {
  constexpr bool kQuant = !std::is_same<T, TP>::value;
  const bool far = far_k != nullptr;
  const bool cur = cur_k != nullptr;
  // the far view and the quantized tier are exclusive; the far view and
  // the pool-only form too; cur_k and cur_v go together
  if (!scales_fit<T, TP>(k_scale, v_scale) || (kQuant && far) ||
      (far && !cur) || cur != (cur_v != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H / KV, hd, BT, far ? CAP : 0);
  // (a quantized pool has no far instantiation: kFar = !kQuant)
  auto kernel = far   ? paged_decode_kernel<T, TP, !kQuant, true>
                : cur ? paged_decode_kernel<T, TP, false, true>
                      : paged_decode_kernel<T, TP, false, false>;
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

// The double-buffered kernel's: its tile and two stages of pool_elem-byte
// pool elements.
size_t paged_decode_db_smem_bytes(int n_rep, int hd, int BT, int pool_elem) {
  return db_smem_bytes(n_rep, hd, BT, pool_elem);
}

// One entry per (q dtype, pool dtype). Null cur_k / cur_v: the pool-only
// form. Null far_k / far_v / far_table / far_valid / far_util: no far view.
// k_scale / v_scale: (P, KV) f32 for a quantized pool, null otherwise.
#define PAGED_DECODE_ENTRY(NAME, T, TP)                                      \
  int NAME(const void* q, const void* pool_k, const void* pool_v,           \
           const void* block_table, const void* window_base,                \
           const void* seq_lens, const void* slot_active, const void* cur_k, \
           const void* cur_v, const void* k_scale, const void* v_scale,     \
           const void* far_k, const void* far_v, const void* far_table,     \
           const void* far_valid, void* out, void* far_util, int B, int H,  \
           int KV, int hd, int BT, int NB, int MAXC, int CAP,               \
           int near_window, int skip_extent, float scale, int threads,      \
           void* stream) {                                                  \
    return launch<T, TP>(q, pool_k, pool_v, block_table, window_base,       \
                         seq_lens, slot_active, cur_k, cur_v, k_scale,      \
                         v_scale, far_k, far_v, far_table, far_valid, out,  \
                         far_util, B, H, KV, hd, BT, NB, MAXC, CAP,         \
                         near_window, skip_extent, scale, threads, stream); \
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
