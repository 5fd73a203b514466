// Building blocks of the fused decode-layer kernels (megakernel.cu,
// int8_attn_tail.cu): a split-K product of a few activation rows with a
// block of columns of an int8 weight, and the per-row pass that finishes
// such a product (fixed-order sum, scale, residual) and applies a
// weight-only LayerNorm.
//
// The TPU kernels these serve run one sequential grid and norm "once at
// the phase boundary"; here the columns of a product come from many CTAs,
// so each phase is a kernel of its own and the phases are enqueued back to
// back by one C entry point. Sums across CTAs go through an f32 workspace
// and are added in a fixed order: no atomics, so a result is the same from
// run to run.
#pragma once
#include "mlp_common.cuh"

namespace otter {

constexpr int RB = 128;         // output columns per CTA
constexpr int RNT = 256;        // threads per CTA
constexpr int RKC = 64;         // weight rows per pipeline stage
constexpr int RNS = 3;          // stages in flight
constexpr int RKG = RNT / 32;   // row groups of a stage, one warp each
constexpr int RMAX = 32;        // largest M (decode shapes)
constexpr int RNORM_NT = 1024;  // threads of a row_norm CTA

template <int MT>
union RowsSmem {
  struct {
    int8_t w[RNS][RKC][RB];
    __nv_bfloat16 x[RNS][MT][RKC];
  } st;
  float red[RKG][MT][RB];   // each row group's partial sums
};

// ws[s, m, j0 + c] = x[m, rows_s] @ w[rows_s, j0 + c] for CTA (j, s) of a
// grid (N / 128, splits): x [M, K] bf16, w int8 with row stride ldw (a
// block of N columns of a wider matrix: the caller offsets the pointer),
// rows_s the s-th run of K / splits weight rows (a multiple of 64). The
// block streams through shared memory in 64-row stages, three in flight
// (cp.async); warp g sums rows 8 g .. 8 g + 7 of every stage for 4 columns
// a lane, MT rows of x at a time, and the warps' sums are added in order.
template <int MT>
__global__ void __launch_bounds__(RNT) int8_matmul_partial_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    float* __restrict__ ws, int M, int K, int N, int ldw) {
  __shared__ __align__(16) RowsSmem<MT> sm;
  const int tid = threadIdx.x;
  const int kg = tid / 32, c4 = (tid % 32) * 4;
  const int j0 = blockIdx.x * RB;
  const int kr = K / gridDim.y, kb = blockIdx.y * kr, nk = kr / RKC;

  for (int m0 = 0; m0 < M; m0 += MT) {
    auto load = [&](int stage, int kc) {
      const int k0 = kb + kc * RKC;
      for (int e = tid; e < RKC * (RB / 16); e += RNT) {
        const int r = e / (RB / 16), cv = e % (RB / 16);
        cp_async16(&sm.st.w[stage][r][cv * 16],
                   w + (long long)(k0 + r) * ldw + j0 + cv * 16, true);
      }
      for (int e = tid; e < MT * (RKC / 8); e += RNT) {
        const int r = e / (RKC / 8), cv = e % (RKC / 8), m = m0 + r;
        const bool ok = m < M;
        cp_async16(&sm.st.x[stage][r][cv * 8],
                   ok ? x + (long long)m * K + k0 + cv * 8 : x, ok);
      }
      cp_async_commit();
    };
    float acc[MT][4];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[r][t] = 0.f;
#pragma unroll
    for (int s = 0; s < RNS - 1; ++s) {
      if (s < nk) load(s, s);
      else cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<RNS - 2>();
      __syncthreads();
      // the stage refilled here was consumed in the previous iteration
      if (kc + RNS - 1 < nk) load((kc + RNS - 1) % RNS, kc + RNS - 1);
      else cp_async_commit();
      const int cur = kc % RNS;
#pragma unroll
      for (int kk = kg * (RKC / RKG); kk < (kg + 1) * (RKC / RKG); ++kk) {
        const char4 wv =
            *reinterpret_cast<const char4*>(&sm.st.w[cur][kk][c4]);
        const float w0 = wv.x, w1 = wv.y, w2 = wv.z, w3 = wv.w;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float xv = __bfloat162float(sm.st.x[cur][r][kk]);
          acc[r][0] = fmaf(xv, w0, acc[r][0]);
          acc[r][1] = fmaf(xv, w1, acc[r][1]);
          acc[r][2] = fmaf(xv, w2, acc[r][2]);
          acc[r][3] = fmaf(xv, w3, acc[r][3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the stages are read: red may reuse their space
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) sm.red[kg][r][c4 + t] = acc[r][t];
    __syncthreads();
    for (int e = tid; e < MT * RB; e += RNT) {
      const int r = e / RB, col = e % RB, m = m0 + r;
      if (m >= M) continue;
      float z = 0.f;
#pragma unroll
      for (int g = 0; g < RKG; ++g) z += sm.red[g][r][col];
      ws[((long long)blockIdx.y * M + m) * N + j0 + col] = z;
    }
    __syncthreads();   // red is read before the next rows' stages land
  }
}

// Whether (M, K, N, ldw, splits) is a shape the product kernel takes.
inline bool matmul_partial_ok(int M, int K, int N, int ldw, int splits) {
  return M >= 1 && M <= RMAX && N % RB == 0 && ldw % 16 == 0 && K % 8 == 0 &&
         splits >= 1 && K % (RKC * splits) == 0;
}

inline int launch_matmul_partial(const void* x, const void* w, void* ws,
                                 int M, int K, int N, int ldw, int splits,
                                 cudaStream_t st) {
  const dim3 grid(N / RB, splits);
  if (M == 1)
    int8_matmul_partial_kernel<1><<<grid, RNT, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)w, (float*)ws, M, K, N, ldw);
  else
    int8_matmul_partial_kernel<8><<<grid, RNT, 0, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)w, (float*)ws, M, K, N, ldw);
  return (int)cudaGetLastError();
}

// The sum of `v` over the CTA, the same in every thread: lanes by
// shuffles, then the warps' sums in order (reproducible). `red` holds one
// float a warp; the CTA is synchronized before it returns.
__device__ __forceinline__ float cta_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();   // the previous call's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int wp = 0; wp < (int)blockDim.x / 32; ++wp) total += red[wp];
  return total;
}

// One CTA of 1024 threads a row m (a thread's loads of the partial sums
// are independent but each waits on L2, so the row is spread over many
// threads and the loop over the partials is unrolled). The row is x[m]
// itself (ws == nullptr), or
//   y[m] = bf16(x[m] + bf16((sum over the nsplit partials ws[s, m]) * scale))
// (the product rounded to bf16 before the residual is added in f32), which
// is stored to y_out. Then the weight-only LayerNorm in f32 (two passes
// over the row kept in shared memory: mean, then the mean of squared
// deviations), normed[m] = bf16((y - mean) * rsqrt(var + eps) * gain).
__global__ void __launch_bounds__(RNORM_NT) row_norm_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ ws,
    int nsplit, const float* __restrict__ scale,
    const float* __restrict__ gain, __nv_bfloat16* __restrict__ y_out,
    __nv_bfloat16* __restrict__ normed, int M, int D, float eps) {
  extern __shared__ float row[];   // D floats
  __shared__ float red[RNORM_NT / 32];
  const int m = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long off = (long long)m * D;
  float part = 0.f;
  for (int c = tid; c < D; c += nt) {
    float v = __bfloat162float(x[off + c]);
    if (ws != nullptr) {
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < nsplit; ++s)
        acc += ws[((long long)s * M + m) * D + c];
      const __nv_bfloat16 y = __float2bfloat16(
          v + __bfloat162float(__float2bfloat16(acc * scale[c])));
      y_out[off + c] = y;
      v = __bfloat162float(y);
    }
    row[c] = v;
    part += v;
  }
  const float mean = cta_sum(part, red) / (float)D;
  part = 0.f;
  for (int c = tid; c < D; c += nt) {
    const float dv = row[c] - mean;
    part += dv * dv;
  }
  const float rstd = 1.f / sqrtf(cta_sum(part, red) / (float)D + eps);
  for (int c = tid; c < D; c += nt)
    normed[off + c] = __float2bfloat16((row[c] - mean) * rstd * gain[c]);
}

inline int launch_row_norm(const void* x, const void* ws, int nsplit,
                           const void* scale, const void* gain, void* y_out,
                           void* normed, int M, int D, float eps,
                           cudaStream_t st) {
  if ((size_t)D * sizeof(float) > 48 * 1024) return (int)cudaErrorInvalidValue;
  row_norm_kernel<<<M, RNORM_NT, D * sizeof(float), st>>>(
      (const __nv_bfloat16*)x, (const float*)ws, nsplit, (const float*)scale,
      (const float*)gain, (__nv_bfloat16*)y_out, (__nv_bfloat16*)normed, M, D,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace otter
