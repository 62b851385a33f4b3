// Warp-level tensor-core pieces for bf16 attention tiles on Hopper (sm_90a):
// 16-byte cp.async copies into a shared-memory ring, ldmatrix loaders,
// the m16n8k16 bf16 mma with f32 accumulators, and the online-softmax
// step over one warp's score fragments (prefill_flash.cu).
//
// Fragment layout of mma.m16n8k16 (lane = threadIdx.x % 32, quad row
// qr = lane / 4, quad column qc = lane % 4):
//   A (16 x 16, row-major): a0 = (qr, 2qc..2qc+1), a1 = (qr + 8, same),
//                           a2 = (qr, 8 + 2qc..), a3 = (qr + 8, 8 + 2qc..)
//   B (16 x 8, k x n):      b0 = (k 2qc..2qc+1, n qr), b1 = (k 8 + 2qc.., n qr)
//   C (16 x 8, f32):        c0, c1 = (qr, 2qc..2qc+1), c2, c3 = (qr + 8, ..)
// So a thread holds two rows of every C tile, and two neighbouring C tiles
// (keys 16kk..16kk+15) of a score row are, rounded to bf16, exactly the A
// fragment of the next product (P.V): no shared-memory round trip.
//
// Everything here is __forceinline__: a shared helper that was not inlined
// cost the decode kernel 27% (PERF.md, Findings).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace kvrm {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous, cached in L2 only. With
// `valid` false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared, asynchronous (cached in L1 and L2). With
// `valid` false the 4 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and receives element (l / 4, 2 (l % 4)..+1) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// The same, each matrix transposed: lane l receives (2 (l % 4)..+1, l / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a . b on the tensor cores: bf16 inputs (their products exact in
// f32), f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ftz); 2^-inf = +0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one bf16x2 register (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The pair (x, y) as the sum of N bf16x2 registers: part i is what parts
// 0..i-1 leave, rounded to nearest even (each rest is exact in f32). Two
// parts hold about 16 significant bits, three about 24, so a product with
// an exact bf16 operand taken as N mma keeps that precision (the split-KV
// decode kernel's P.V).
template <int N>
__device__ __forceinline__ void pack_bf16_parts(float x, float y,
                                                uint32_t (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    p[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 hf = __bfloat1622float2(h);
    x -= hf.x;
    y -= hf.y;
  }
}

// One online-softmax step over a warp's score fragments s[NT][4]: NT tiles
// of 8 keys of raw dot products q.k, -inf where masked. scale_log2 is
// log2(e) / sqrt(hd), so 2^(x scale_log2) = e^(x / sqrt(hd)). The thread's
// two rows are i = 0 (c0, c1) and i = 1 (c2, c3); m[i] is the row's
// running max of raw scores (quad-uniform), l[i] this thread's share of
// the row's running sum (the quad's four shares are summed once, after the
// last step). On return s holds p = e^((s - m_new) / sqrt(hd)), one FMA and
// one ex2 each, and corr[i] = e^((m_prev - m_new) / sqrt(hd)), by which the
// caller scales its output accumulator. A masked key adds nothing; a tile
// fully masked for a row leaves that row's (m, l) as they were and gives
// corr 1.
template <int NT>
__device__ __forceinline__ void online_softmax_step(float (&s)[NT][4],
                                                    float (&m)[2],
                                                    float (&l)[2],
                                                    float (&corr)[2],
                                                    float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mc = mx * scale_log2;
    float psum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        const float p = exp2_approx(fmaf(s[nt][e], scale_log2, -mc));
        s[nt][e] = p;
        psum += p;
      }
    }
    corr[i] = exp2_approx((m[i] - mx) * scale_log2);
    l[i] = l[i] * corr[i] + psum;
    m[i] = mx;
  }
}

// The same step over scores already scaled by 1 / sqrt(hd) (-inf where
// masked), in the plain version's arithmetic: p = expf(s - m_new) and
// corr = expf(m_prev - m_new) with the accurate expf, m the row's running
// max of scaled scores (the split-KV decode kernel, whose partials must
// agree with an f32 softmax to a few ulps).
template <int NT>
__device__ __forceinline__ void online_softmax_step_exp(float (&s)[NT][4],
                                                        float (&m)[2],
                                                        float (&l)[2],
                                                        float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float psum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        const float p = expf(s[nt][e] - mx);
        s[nt][e] = p;
        psum += p;
      }
    }
    corr[i] = expf(m[i] - mx);
    l[i] = l[i] * corr[i] + psum;
    m[i] = mx;
  }
}

}  // namespace mma
}  // namespace kvrm
