// The fused int8 MLP's main kernel, shared by int8_mlp.cu and
// int8_attn_tail.cu (its phase 3): CTA j computes the hidden units
// [128 j, 128 j + 128) of act((x @ W1q) * s1 + b1), rounds them to bf16 in
// shared memory, and writes its share of hidden @ W2q to its slice of an
// f32 workspace [H/128, M, N]; `launch_sum_partials` (mlp_common.cuh) adds
// the slices in a fixed order.
//
// Replaces the body of the Pallas TPU kernel otter_tpu/ops/quant.py:int8_mlp
// (:84, pallas_call :185), and the MLP half of int8_attn_tail (:199): every
// int8 weight converted to bf16 (exact), the products summed in f32, the
// hidden activation rounded to bf16 before the second product. Only the
// order of the sums differs.
//
// What bounds it on the H100: bytes. A call reads K*H + H*N int8 weights
// once (134 MB at 4096 -> 16384 -> 4096: 40 us at 3.35 TB/s) for 2 M
// operations a weight, M <= 32: at most 64 operations a byte, far below the
// ~295 a byte at which the bf16 tensor cores would bound it. So the
// products cost little; what must stay low is the instructions a weight
// byte (to issue no slower than the bytes arrive), and what must stay high
// is the bytes in flight (Little's law: 3.35 TB/s x ~1 us / 132 SMs ~ 25 KB
// an SM).
//
// Design:
// - Products on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
//   accumulators) with the operands swapped. A 16-row tile of weights (16
//   hidden units in phase 1, 16 output columns in phase 2) is the A
//   operand; the M <= 32 activation rows are the B operand, in 1 to 4
//   n-tiles of 8. mma.sync rather than wgmma: the call is ~2.1 GFLOP at
//   M = 8, nothing beside 989 TFLOP/s, and mma.sync takes its A fragment
//   from any registers, so the int8 bytes go from shared memory to the
//   tensor cores with no layout to meet and no warpgroup to keep together.
// - int8 -> bf16 in registers without I2F, and no transposing pass: the
//   weights land in shared memory as they lie in device memory, and the
//   A fragments are permuted out of them as int8_mma.cuh describes (its
//   `a_frags`, `k_steps` and swizzles, shared with int8_rows.cuh's split-K
//   product). Each weight is converted once a call, whatever M is; the
//   hidden block's and the output's writes undo the fragments' column
//   order.
// - One weight stream for every M <= 32: the n-tiles sit inside the tile
//   loop (ceil(M/8) accumulators a fragment), so W1 and W2 are read once.
// - One ring for both phases: NS stages of 32 KB of weights (W1: 256 rows
//   of the CTA's 128 columns, with the matching 256 columns of x's rows;
//   W2: the CTA's 128 rows by 256 columns), filled by cp.async NS - 1
//   stages ahead, so W2's first stages are in flight while phase 1 ends.
//   NS = 4 keeps 96 KB in flight an SM. A grid of more CTAs than SMs
//   (falcon7b's 142) runs two stages a CTA and two CTAs an SM where they
//   fit (M <= 24): the same bytes in flight, and no second wave.
// - Phase 1: warp w takes hidden units 32 (w % 4) .. + 31 over half the
//   rows of every stage (w / 4); the two halves are added in a fixed order
//   through shared memory, scaled by s1, biased, activated and rounded to
//   bf16 into shared memory. Phase 2: warp w takes output columns 32 w ..
//   + 31 of every stage over the CTA's 128 hidden rows and stores its sums
//   to the CTA's workspace slice. No atomics: two calls give the same bits.
#pragma once
#include "int8_mma.cuh"
#include "mlp_common.cuh"

namespace otter {

constexpr int BH = 128;       // hidden units per CTA
constexpr int NT = 256;       // threads per CTA: 8 warps
constexpr int MMAX = 32;      // largest M (decode shapes)
constexpr int KC = 64;        // K is a multiple of KC
constexpr int R1 = 256;       // phase 1: W1 rows a stage (x BH columns)
constexpr int C2 = 256;       // phase 2: W2 columns a stage (x BH rows)
constexpr int SW = R1 * BH;   // weight bytes a stage, either phase: 32 KB

// Shared memory with NB n-tiles (M <= 8 NB) and NS stages: the ring (each
// stage: its weights, then for phase 1 x's 8 NB rows of R1 bf16), the bf16
// hidden block hs [8 NB][BH] and phase 1's f32 half sums red [8 NB][BH].
template <int NB, int NS>
struct Layout {
  static constexpr int XROW = R1 * 2;
  static constexpr int STAGE = SW + 8 * NB * XROW;
  static constexpr int HS = NS * STAGE;
  static constexpr int RED = HS + 8 * NB * BH * 2;
  static constexpr int BYTES = RED + 8 * NB * BH * 4;
};

template <int NB, int NS>
__global__ void __launch_bounds__(NT, NS == 2 ? 2 : 1) int8_mlp_hidden_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w1,
    const float* __restrict__ s1, const float* __restrict__ b1,
    const int8_t* __restrict__ w2, float* __restrict__ ws, int M, int K,
    int H, int N, int act) {
  using L = Layout<NB, NS>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int j0 = blockIdx.x * BH;
  const int n1 = (K + R1 - 1) / R1, n2 = (N + C2 - 1) / C2;

  // stage i of the stream (W1's n1, then W2's n2) into ring slot i % NS,
  // chunks swizzled by `w_chunk` / `x_chunk`; past K or N, zeros
  auto load = [&](int i) {
    unsigned char* st = smem + (i % NS) * L::STAGE;
    if (i < n1) {
      const int k0 = i * R1;
      for (int e = tid; e < R1 * (BH / 16); e += NT) {
        const int r = e >> 3, c = e & 7;
        const bool ok = k0 + r < K;
        cp_async16(st + r * BH + w_chunk(r, c),
                   ok ? w1 + (long long)(k0 + r) * H + j0 + c * 16 : w1, ok);
      }
      for (int e = tid; e < 8 * NB * (R1 / 8); e += NT) {
        const int m = e / (R1 / 8), c = e % (R1 / 8);
        const bool ok = m < M && k0 + c * 8 < K;
        cp_async16(st + SW + m * L::XROW + x_chunk(m, c),
                   ok ? x + (long long)m * K + k0 + c * 8 : x, ok);
      }
    } else if (i < n1 + n2) {
      const int c0 = (i - n1) * C2;
      for (int e = tid; e < BH * (C2 / 16); e += NT) {
        const int r = e >> 4, c = e & 15;
        const bool ok = c0 + c * 16 < N;
        cp_async16(st + r * C2 + w_chunk(r, c),
                   ok ? w2 + (long long)(j0 + r) * N + c0 + c * 16 : w2, ok);
      }
    }
    cp_async_commit();
  };

  // phase 1 mapping: hidden units 32 hg .. + 31, rows 128 kh .. + 127 of
  // a stage; a thread's quad is units 32 hg + 4 g .. + 3
  const int hg = warp & 3, kh = warp >> 2;
  const int wcol1 = w_quad(hg, g, t);
  // phase 2 mapping: output columns 32 warp .. + 31 of a stage
  const int wcol2 = w_quad(warp, g, t);
  unsigned char* hs = smem + L::HS;
  float* red = reinterpret_cast<float*>(smem + L::RED);

  float acc1[2][NB][4];
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc1[tl][n][c] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) load(s);
  for (int i = 0; i < n1 + n2; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    // the slot refilled here was read in the previous iteration
    load(i + NS - 1);
    const unsigned char* st = smem + (i % NS) * L::STAGE;
    if (i < n1) {
      k_steps<NB, BH, L::XROW>(st, 128 * kh, wcol1, st + SW, 128 * kh, g, t,
                               acc1);
      if (i == n1 - 1) {
        // hidden unit 32 hg + 4 g + 2 tl + c / 2 of row 8 n + 2 t + c % 2;
        // the two row halves are added in a fixed order
        if (kh == 1) {
#pragma unroll
          for (int tl = 0; tl < 2; ++tl)
#pragma unroll
            for (int n = 0; n < NB; ++n)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                red[(8 * n + 2 * t + (c & 1)) * BH + 32 * hg + 4 * g +
                    2 * tl + (c >> 1)] = acc1[tl][n][c];
        }
        __syncthreads();
        if (kh == 0) {
#pragma unroll
          for (int tl = 0; tl < 2; ++tl)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = 32 * hg + 4 * g + 2 * tl + (c >> 1);
              const float sc = s1[j0 + j];
              const float bias = b1 != nullptr ? b1[j0 + j] : 0.f;
#pragma unroll
              for (int n = 0; n < NB; ++n) {
                const int m = 8 * n + 2 * t + (c & 1);
                // scaled, then biased: two roundings, as the plain version
                const float z =
                    __fmul_rn(acc1[tl][n][c] + red[m * BH + j], sc) + bias;
                *reinterpret_cast<__nv_bfloat16*>(
                    hs + m * (BH * 2) + x_chunk(m, j >> 3) + 2 * (j & 7)) =
                    __float2bfloat16(apply_act(z, act));
              }
            }
        }
        __syncthreads();
      }
    } else {
      float acc2[2][NB][4];
#pragma unroll
      for (int tl = 0; tl < 2; ++tl)
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc2[tl][n][c] = 0.f;
      k_steps<NB, C2, BH * 2>(st, 0, wcol2, hs, 0, g, t, acc2);
      // column col + q of row 8 n + 2 t + e: acc2[q / 2][n][2 (q % 2) + e]
      const int col = (i - n1) * C2 + 32 * warp + 4 * g;
      if (col < N) {
        float* out = ws + (long long)blockIdx.x * M * N + col;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 8 * n + 2 * t + e;
            if (m < M)
              *reinterpret_cast<float4*>(out + (long long)m * N) =
                  make_float4(acc2[0][n][e], acc2[0][n][2 + e],
                              acc2[1][n][e], acc2[1][n][2 + e]);
          }
      }
    }
  }
  cp_async_wait<0>();
}

template <int NB, int NS>
int launch_hidden_ns(const void* x, const void* w1, const void* s1,
                     const void* b1, const void* w2, void* ws, int M, int K,
                     int H, int N, int act, cudaStream_t st) {
  constexpr int smem = Layout<NB, NS>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      int8_mlp_hidden_kernel<NB, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int8_mlp_hidden_kernel<NB, NS><<<H / BH, NT, smem, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w1, (const float*)s1,
      (const float*)b1, (const int8_t*)w2, (float*)ws, M, K, H, N, act);
  return (int)cudaGetLastError();
}

// four stages for a grid of one wave; for more CTAs than SMs, two stages
// and two CTAs an SM where two fit its 228 KB (each CTA reserves 1 KB)
template <int NB>
int launch_hidden_nb(const void* x, const void* w1, const void* s1,
                     const void* b1, const void* w2, void* ws, int M, int K,
                     int H, int N, int act, cudaStream_t st) {
  if constexpr (2 * (Layout<NB, 2>::BYTES + 1024) <= 228 * 1024) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (H / BH > sms)
      return launch_hidden_ns<NB, 2>(x, w1, s1, b1, w2, ws, M, K, H, N, act,
                                     st);
  }
  return launch_hidden_ns<NB, 4>(x, w1, s1, b1, w2, ws, M, K, H, N, act, st);
}

// The kernel takes ceil(M / 8) n-tiles and streams the weights once for
// any M <= MMAX. MT is kept in the signature for the callers
// (int8_attn_tail.cu passes 1 or 8) and no longer picks a variant.
template <int MT>
int launch_hidden(const void* x, const void* w1, const void* s1,
                  const void* b1, const void* w2, void* ws, int M, int K,
                  int H, int N, int act, cudaStream_t st) {
  switch ((M + 7) / 8) {
    case 1:
      return launch_hidden_nb<1>(x, w1, s1, b1, w2, ws, M, K, H, N, act, st);
    case 2:
      return launch_hidden_nb<2>(x, w1, s1, b1, w2, ws, M, K, H, N, act, st);
    case 3:
      return launch_hidden_nb<3>(x, w1, s1, b1, w2, ws, M, K, H, N, act, st);
    default:
      return launch_hidden_nb<4>(x, w1, s1, b1, w2, ws, M, K, H, N, act, st);
  }
}

}  // namespace otter
