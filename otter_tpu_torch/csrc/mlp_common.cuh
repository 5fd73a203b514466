// Shared by the weight-only quantized product kernels (int8_mlp.cu,
// int4_mlp.cu, int8_attn_tail.cu, megakernel.cu): activations, cp.async
// helpers, and the launch that sums the CTAs' partial outputs in a fixed
// order.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace otter {

__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case 0: return 0.5f * z * (1.f + erff(z * 0.7071067811865476f));  // gelu
    case 1: return fmaxf(z, 0.f);                                      // relu
    case 2: return z / (1.f + expf(-z));                               // silu
    default: { const float r = fmaxf(z, 0.f); return r * r; }          // sq_relu
  }
}

// 16-byte global -> shared copy that bypasses registers (zero-fills when
// !pred; src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
// 4-byte copy of the same kind (through L1: .cg takes 16 bytes only)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch (sm_90). A kernel launched with
// `launch_kernel(true, ...)` may start while the kernel before it on the
// stream still runs: before `pdl_wait` it must read only what no earlier
// kernel of the step writes (weights, scales, gains, the ALiBi bias) and
// write nothing to global memory; `pdl_wait` returns once that kernel has
// finished and its writes are visible (at once for a plain launch).
// `pdl_launch_dependents` lets the next such kernel start early, once
// every CTA of this one has executed it or exited.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launch `kernel` on `st`, with `pdl` as a programmatic dependent of the
// kernel before it; returns the launch's error.
template <typename... Params, typename... Args>
inline int launch_kernel(bool pdl, void (*kernel)(Params...), dim3 grid,
                         int threads, int smem, cudaStream_t st,
                         Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// out = (sum over the nblk partial outputs ws[blk] [M, N], in order)
//       * scale + bias, cast to bf16; with a residual `resid` [M, N] bf16,
// out = bf16(resid + that bf16 value): the product is rounded to the
// activation dtype before the residual is added in f32. No atomics: the
// result is the same from run to run, so greedy decoding is reproducible.
__global__ void sum_partials_kernel(const float* __restrict__ ws,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias,
                                    const __nv_bfloat16* __restrict__ resid,
                                    __nv_bfloat16* __restrict__ out, int M,
                                    int N, int nblk) {
  pdl_wait();   // ws comes from the kernel before
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int n = i % N;
  const long long stride = (long long)M * N;
  float acc = 0.f;
  for (int blk = 0; blk < nblk; ++blk) acc += ws[blk * stride + i];
  float y = acc * scale[n];
  if (bias != nullptr) y += bias[n];
  if (resid != nullptr)
    y = __bfloat162float(resid[i]) + __bfloat162float(__float2bfloat16(y));
  out[i] = __float2bfloat16(y);
}

inline int launch_sum_partials(const void* ws, const void* scale,
                               const void* bias, void* out, int M, int N,
                               int nblk, cudaStream_t st,
                               const void* resid = nullptr,
                               bool pdl = false) {
  const int total = M * N;
  return launch_kernel(pdl, sum_partials_kernel, dim3((total + 255) / 256),
                       256, 0, st, (const float*)ws, (const float*)scale,
                       (const float*)bias, (const __nv_bfloat16*)resid,
                       (__nv_bfloat16*)out, M, N, nblk);
}

// The same sum for a short output and many slices (the fused int4 MLP's:
// M N as small as 4096, 128 or more slices), where one thread a value
// would wait on its loads one after another: 8 warps a 32-value block,
// warp q adding the slices q, q + 8, ... in order, then the 8 sums added
// in order. out = that sum * scale, cast to bf16. N % 32 == 0. No
// atomics: the same bits every call.
__global__ void __launch_bounds__(256) sum_partials_grouped_kernel(
    const float* __restrict__ ws, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ out, int M, int N, int nblk) {
  __shared__ float red[8][32];
  pdl_wait();   // ws comes from the kernel before
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const long long stride = (long long)M * N;
  float acc = 0.f;
#pragma unroll 4
  for (int blk = q; blk < nblk; blk += 8) acc += ws[blk * stride + i];
  red[q][lane] = acc;
  __syncthreads();
  if (q == 0) {
    float y = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) y += red[r][lane];
    out[i] = __float2bfloat16(y * scale[i % N]);
  }
}

inline int launch_sum_partials_grouped(const void* ws, const void* scale,
                                       void* out, int M, int N, int nblk,
                                       cudaStream_t st, bool pdl) {
  return launch_kernel(pdl, sum_partials_grouped_kernel, dim3(M * N / 32),
                       256, 0, st, (const float*)ws, (const float*)scale,
                       (__nv_bfloat16*)out, M, N, nblk);
}

}  // namespace otter
