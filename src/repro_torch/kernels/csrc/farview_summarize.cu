// Far-view chunk summarization for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_sum_kernel` in
// src/repro/kernels/farview_summarize.py, and computes what
// `ref.farview_summarize_ref` computes, for a layer's K and V pools in one
// launch (pool 0 and pool 1):
//
//   out[p][b, c] = do_summarize[b] > 0
//       ? (sum over rows r < min(n_tokens[b], CB * BT) of
//          pool[p][chunk_blocks[b, r / BT], r % BT, c]) / max(n_tokens[b], 1)
//       : 0
//
// summed in f32 and cast to the pool's type once. The payload of a pool
// row is flattened to `width` elements, so any payload shape is taken.
//
// Design. One thread block per (slot, column tile, pool); each thread owns
// one column and walks the chunk's rows in order, so neighbouring threads
// read neighbouring addresses of a row (coalesced) and the sum order is
// fixed (deterministic from run to run). The gate is read inside the
// kernel: a slot with no completed chunk writes zeros and reads no pool
// byte, so the launch is the same fixed-shape call every step and no host
// branch depends on whether a chunk completed. The TPU's sequential block
// axis (grid (B, CB) with a VMEM accumulator) becomes the row loop.
//
// Bound. It reads each summarized row once and writes one row per slot:
// bound by memory bytes, and only gated slots move pool bytes. At full
// qwen2.5-32b width (KV 8 x hd 128 = 1024 values per row, bf16) a 64-token
// chunk of K and V is 256 KiB, about 78 ns at 3.35 TB/s.
#include "online_softmax.cuh"

namespace {

using kvrm::store_as;
using kvrm::to_f32;

template <typename T>
__global__ void farview_summarize_kernel(
    const T* __restrict__ pool0,        // (P, BT, width)
    const T* __restrict__ pool1,        // (P, BT, width)
    const int* __restrict__ chunk_blocks,  // (B, CB)
    const int* __restrict__ n_tokens,      // (B,)
    const int* __restrict__ do_summarize,  // (B,)
    T* __restrict__ out0,               // (B, width)
    T* __restrict__ out1,               // (B, width)
    int CB, int BT, int width) {
  const int b = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= width) return;
  const T* pool = blockIdx.z == 0 ? pool0 : pool1;
  T* out = (blockIdx.z == 0 ? out0 : out1) + (size_t)b * width + c;
  if (do_summarize[b] <= 0) {
    store_as(out, 0.f);
    return;
  }
  const int n_tok = n_tokens[b];
  const int rows = min(max(n_tok, 0), CB * BT);
  const int* blocks = chunk_blocks + (size_t)b * CB;
  float acc = 0.f;
  for (int r = 0; r < rows; ++r) {
    const int blk = blocks[r / BT];
    acc += to_f32(pool[((size_t)blk * BT + (r % BT)) * width + c]);
  }
  store_as(out, acc / (float)max(n_tok, 1));
}

template <typename T>
int launch(const void* pool0, const void* pool1, const void* chunk_blocks,
           const void* n_tokens, const void* do_summarize, void* out0,
           void* out1, int B, int CB, int BT, int width, int threads,
           void* stream) {
  dim3 grid(B, (width + threads - 1) / threads, 2);
  farview_summarize_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)pool0, (const T*)pool1, (const int*)chunk_blocks,
      (const int*)n_tokens, (const int*)do_summarize, (T*)out0, (T*)out1, CB,
      BT, width);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int farview_summarize_bf16(const void* pool0, const void* pool1,
                           const void* chunk_blocks, const void* n_tokens,
                           const void* do_summarize, void* out0, void* out1,
                           int B, int CB, int BT, int width, int threads,
                           void* stream) {
  return launch<__nv_bfloat16>(pool0, pool1, chunk_blocks, n_tokens,
                               do_summarize, out0, out1, B, CB, BT, width,
                               threads, stream);
}

int farview_summarize_f32(const void* pool0, const void* pool1,
                          const void* chunk_blocks, const void* n_tokens,
                          const void* do_summarize, void* out0, void* out1,
                          int B, int CB, int BT, int width, int threads,
                          void* stream) {
  return launch<float>(pool0, pool1, chunk_blocks, n_tokens, do_summarize,
                       out0, out1, B, CB, BT, width, threads, stream);
}

}  // extern "C"
