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
//
// The product (`int8_matmul_partial_kernel`) is bound by its weight bytes:
// M <= 32 rows of x make at most 64 operations a weight byte. Its design,
// for the H100:
// - mma.sync m16n8k16 on the tensor cores, the int8 weight tile as the A
//   operand converted in registers and x's rows as the B operand
//   (int8_mma.cuh, shared with the fused MLP), so a weight costs ~3
//   instructions whatever M is, where f32 FMAs on the CUDA cores cost ~13
//   at M = 8.
// - One weight stream for any M <= 32: ceil(M / 8) n-tiles inside the tile
//   loop (template instantiations of 1 to 4), no pass over M.
// - A CTA of 8 warps takes 128 columns and a run of K / splits rows, in
//   stages of 128 rows (16 KB) through a cp.async ring of four slots:
//   48 KB in flight a CTA, and two or three CTAs an SM (73 KB of shared
//   memory at M <= 8, up to 96 KB above). The host's plan (ops/quant.py:
//   split_k_rows) keeps the grid within one wave of them.
#pragma once
#include "int8_mma.cuh"
#include "mlp_common.cuh"

namespace otter {

constexpr int RB = 128;         // output columns per CTA
constexpr int RNT = 256;        // threads per CTA: 8 warps
constexpr int RKC = 128;        // weight rows per pipeline stage
constexpr int RNS = 4;          // ring slots (RNS - 1 stages in flight)
constexpr int RMAX = 32;        // largest M (decode shapes)
constexpr int RNORM_NT = 1024;  // threads of a row_norm CTA

// Shared memory of the product with NB n-tiles (M <= 8 NB): RNS ring
// slots, each 128 weight rows of the CTA's 128 columns (16 KB) and the
// matching 128 columns of x's 8 NB rows (bf16). After the walk the ring
// holds the upper row half's sums, [8 NB][RB] f32.
template <int NB>
struct RowsLayout {
  static constexpr int XROW = RKC * 2;
  static constexpr int SW = RKC * RB;
  static constexpr int STAGE = SW + 8 * NB * XROW;
  static constexpr int BYTES = RNS * STAGE;
  static_assert(8 * NB * RB * 4 <= BYTES, "room for the half sums");
};

// ws[s, m, j0 + c] = x[m, rows_s] @ w[rows_s, j0 + c] for CTA (j, s) of a
// grid (N / 128, splits): x [M, K] bf16, w int8 with row stride ldw (a
// block of N columns of a wider matrix: the caller offsets the pointer),
// rows_s the s-th run of K / splits weight rows (a multiple of 64; a
// last stage of 64 rows is zero-filled). The products run on the tensor
// cores (int8_mma.cuh): warp w takes columns 32 (w % 4) .. + 31 over rows
// 64 (w / 4) .. + 63 of every stage, for all 8 NB rows of x at once, so
// every weight is read once for any M <= 32; the two row halves are added
// in a fixed order through shared memory. The weights of the first RNS - 1
// stages are requested before `pdl_wait`, x's (which the previous kernel
// writes) after it.
template <int NB>
__global__ void __launch_bounds__(RNT, 2) int8_matmul_partial_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    float* __restrict__ ws, int M, int K, int N, int ldw) {
  using L = RowsLayout<NB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int j0 = blockIdx.x * RB;
  const int kr = K / gridDim.y, kb = blockIdx.y * kr;
  const int nk = (kr + RKC - 1) / RKC;

  // stage i's weights / x columns into ring slot i % RNS; past the run of
  // rows, zeros (no commit: the caller groups them)
  auto load_w = [&](int i) {
    if (i >= nk) return;
    unsigned char* st = smem + (i % RNS) * L::STAGE;
    const int r0 = i * RKC;
    for (int e = tid; e < RKC * (RB / 16); e += RNT) {
      const int r = e >> 3, c = e & 7;
      const bool ok = r0 + r < kr;
      cp_async16(st + r * RB + w_chunk(r, c),
                 ok ? w + (long long)(kb + r0 + r) * ldw + j0 + c * 16 : w,
                 ok);
    }
  };
  auto load_x = [&](int i) {
    if (i >= nk) return;
    unsigned char* st = smem + (i % RNS) * L::STAGE + L::SW;
    const int r0 = i * RKC;
    for (int e = tid; e < 8 * NB * (RKC / 8); e += RNT) {
      const int m = e >> 4, c = e & 15;
      const bool ok = m < M && r0 + c * 8 < kr;
      cp_async16(st + m * L::XROW + x_chunk(m, c),
                 ok ? x + (long long)m * K + kb + r0 + c * 8 : x, ok);
    }
  };

  float acc[2][NB][4];
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[tl][n][c] = 0.f;

#pragma unroll
  for (int s = 0; s < RNS - 1; ++s) load_w(s);
  pdl_wait();          // x comes from the kernel before
#pragma unroll
  for (int s = 0; s < RNS - 1; ++s) load_x(s);
  cp_async_commit();   // one group: the first RNS - 1 stages

  const int cg = warp & 3, kh = warp >> 2;
  const int wcol = w_quad(cg, g, t);
  for (int i = 0; i < nk; ++i) {
    if (i == 0) cp_async_wait<0>();
    else cp_async_wait<RNS - 2>();
    __syncthreads();
    // the slot refilled here was read in the previous iteration
    load_w(i + RNS - 1);
    load_x(i + RNS - 1);
    cp_async_commit();
    if (i == max(nk - RNS, 0)) pdl_launch_dependents();  // last loads issued
    const unsigned char* st = smem + (i % RNS) * L::STAGE;
    k_steps<NB, RB, L::XROW, 4>(st, 64 * kh, wcol, st + L::SW, 64 * kh, g,
                                t, acc);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is read: it takes the half sums

  // column 32 cg + 4 g + q of row 8 n + 2 t + e: acc[q / 2][n][2 (q % 2) + e]
  float* red = reinterpret_cast<float*>(smem);
  const int col = 32 * cg + 4 * g;
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(red + (8 * n + 2 * t + e) * RB + col) =
            make_float4(acc[0][n][e], acc[0][n][2 + e], acc[1][n][e],
                        acc[1][n][2 + e]);
  }
  __syncthreads();
  if (kh == 0) {
    float* out = ws + (long long)blockIdx.y * M * N + j0 + col;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * n + 2 * t + e;
        if (m >= M) continue;
        const float4 hi =
            *reinterpret_cast<const float4*>(red + m * RB + col);
        *reinterpret_cast<float4*>(out + (long long)m * N) = make_float4(
            acc[0][n][e] + hi.x, acc[0][n][2 + e] + hi.y,
            acc[1][n][e] + hi.z, acc[1][n][2 + e] + hi.w);
      }
  }
}

// Whether (M, K, N, ldw, splits) is a shape the product kernel takes.
inline bool matmul_partial_ok(int M, int K, int N, int ldw, int splits) {
  return M >= 1 && M <= RMAX && N % RB == 0 && ldw % 16 == 0 && K % 8 == 0 &&
         splits >= 1 && K % (64 * splits) == 0;
}

template <int NB>
int launch_matmul_partial_nb(const void* x, const void* w, void* ws, int M,
                             int K, int N, int ldw, int splits,
                             cudaStream_t st, bool pdl) {
  constexpr int smem = RowsLayout<NB>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_partial_kernel<NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's 228 KB as shared memory: three CTAs of one n-tile fit
  err = cudaFuncSetAttribute(int8_matmul_partial_kernel<NB>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return launch_kernel(pdl, int8_matmul_partial_kernel<NB>,
                       dim3(N / RB, splits), RNT, smem, st,
                       (const __nv_bfloat16*)x, (const int8_t*)w, (float*)ws,
                       M, K, N, ldw);
}

// ceil(M / 8) n-tiles: one weight stream for any M <= RMAX
inline int launch_matmul_partial(const void* x, const void* w, void* ws,
                                 int M, int K, int N, int ldw, int splits,
                                 cudaStream_t st, bool pdl = false) {
  switch ((M + 7) / 8) {
    case 1:
      return launch_matmul_partial_nb<1>(x, w, ws, M, K, N, ldw, splits, st,
                                         pdl);
    case 2:
      return launch_matmul_partial_nb<2>(x, w, ws, M, K, N, ldw, splits, st,
                                         pdl);
    case 3:
      return launch_matmul_partial_nb<3>(x, w, ws, M, K, N, ldw, splits, st,
                                         pdl);
    default:
      return launch_matmul_partial_nb<4>(x, w, ws, M, K, N, ldw, splits, st,
                                         pdl);
  }
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
  pdl_launch_dependents();   // the next kernel may stream its weights
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
