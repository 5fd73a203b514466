// The fused int8 MLP's main kernel, shared by int8_mlp.cu and
// int8_attn_tail.cu: CTA j computes the hidden units [128 j, 128 j + 128)
// of act((x @ W1q) * s1 + b1), rounds them to bf16 in shared memory, and
// writes its share of hidden @ W2q to its slice of an f32 workspace
// [H/128, M, N]; `launch_sum_partials` (mlp_common.cuh) adds the slices.
// int8_mlp.cu describes the design.
#pragma once
#include "mlp_common.cuh"

namespace otter {

constexpr int BH = 128;    // hidden units per CTA
constexpr int NT = 256;    // threads per CTA
constexpr int MMAX = 32;   // largest M (decode shapes)
constexpr int KC = 64;     // phase 1: W1 rows per pipeline stage
constexpr int NS1 = 3;     // phase 1: stages in flight
constexpr int JB = 4;      // phase 2: W2 rows per pipeline stage
constexpr int NCH = 4096;  // phase 2: output columns per pass (NT * 16)
constexpr int NS2 = 4;     // phase 2: stages in flight
constexpr int KG = NT / 32;  // phase 1: K groups, one warp each

template <int MT>
struct Smem {
  float hs[MMAX][BH];   // bf16-rounded hidden activations
  union {
    struct {
      int8_t w[NS1][KC][BH];
      __nv_bfloat16 x[NS1][MT][KC];
    } p1;
    float red[KG][MT][BH];   // phase 1: each K group's partial sums
    int8_t w2[NS2][JB][NCH];
  } u;
};

template <int MT>
__global__ void __launch_bounds__(NT) int8_mlp_hidden_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w1,
    const float* __restrict__ s1, const float* __restrict__ b1,
    const int8_t* __restrict__ w2, float* __restrict__ ws, int M, int K,
    int H, int N, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MT>& sm = *reinterpret_cast<Smem<MT>*>(smem_raw);
  const int j0 = blockIdx.x * BH;
  const int tid = threadIdx.x;
  // phase 1 mapping: warp kg sums rows kg*8..kg*8+7 of every stage for
  // the 4 hidden units c4..c4+3
  const int kg = tid / 32, c4 = (tid % 32) * 4;

  for (int e = tid; e < MMAX * BH; e += NT) sm.hs[e / BH][e % BH] = 0.f;

  // phase 1: hidden block = act(x @ W1[:, j0:j0+BH] * s1 + b1), bf16-rounded
  const int nk = K / KC;
  for (int m0 = 0; m0 < M; m0 += MT) {
    auto load1 = [&](int stage, int kc) {
      const int k0 = kc * KC;
      for (int e = tid; e < KC * (BH / 16); e += NT) {
        const int r = e / (BH / 16), cv = e % (BH / 16);
        cp_async16(&sm.u.p1.w[stage][r][cv * 16],
                   w1 + (long long)(k0 + r) * H + j0 + cv * 16, true);
      }
      for (int e = tid; e < MT * (KC / 8); e += NT) {
        const int r = e / (KC / 8), cv = e % (KC / 8), m = m0 + r;
        const bool ok = m < M;
        cp_async16(&sm.u.p1.x[stage][r][cv * 8],
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
    for (int s = 0; s < NS1 - 1; ++s) {
      if (s < nk) load1(s, s);
      else cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<NS1 - 2>();
      __syncthreads();
      // the stage refilled here was consumed in the previous iteration
      if (kc + NS1 - 1 < nk) load1((kc + NS1 - 1) % NS1, kc + NS1 - 1);
      else cp_async_commit();
      const int st = kc % NS1;
#pragma unroll
      for (int kk = kg * (KC / KG); kk < (kg + 1) * (KC / KG); ++kk) {
        const char4 w = *reinterpret_cast<const char4*>(
            &sm.u.p1.w[st][kk][c4]);
        const float w0 = w.x, w1v = w.y, w2v = w.z, w3 = w.w;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float xv = __bfloat162float(sm.u.p1.x[st][r][kk]);
          acc[r][0] = fmaf(xv, w0, acc[r][0]);
          acc[r][1] = fmaf(xv, w1v, acc[r][1]);
          acc[r][2] = fmaf(xv, w2v, acc[r][2]);
          acc[r][3] = fmaf(xv, w3, acc[r][3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the stages are read: red may reuse their space
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) sm.u.red[kg][r][c4 + t] = acc[r][t];
    __syncthreads();
    // the K groups are added in a fixed order: the result is reproducible
    for (int e = tid; e < MT * BH; e += NT) {
      const int r = e / BH, col = e % BH, m = m0 + r;
      if (m >= M) continue;
      float z = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g) z += sm.u.red[g][r][col];
      z *= s1[j0 + col];
      if (b1 != nullptr) z += b1[j0 + col];
      sm.hs[m][col] = __bfloat162float(__float2bfloat16(apply_act(z, act)));
    }
    __syncthreads();
  }

  // phase 2: ws[blk, :, n] = hidden block @ W2[j0:j0+BH, n]; each thread
  // owns 16 consecutive columns of a 4096-column pass
  constexpr int NJ = BH / JB;
  for (int m0 = 0; m0 < M; m0 += MT) {
    for (int n0 = 0; n0 < N; n0 += NCH) {
      const int nc = min(NCH, N - n0);
      auto load2 = [&](int stage, int jb) {
        for (int e = tid; e < JB * (nc / 16); e += NT) {
          const int r = e / (nc / 16), cv = e % (nc / 16);
          cp_async16(&sm.u.w2[stage][r][cv * 16],
                     w2 + (long long)(j0 + jb * JB + r) * N + n0 + cv * 16,
                     true);
        }
        cp_async_commit();
      };
      float acc[MT][16];
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int t = 0; t < 16; ++t) acc[r][t] = 0.f;
#pragma unroll
      for (int s = 0; s < NS2 - 1; ++s) load2(s, s);
      for (int jb = 0; jb < NJ; ++jb) {
        cp_async_wait<NS2 - 2>();
        __syncthreads();
        if (jb + NS2 - 1 < NJ) load2((jb + NS2 - 1) % NS2, jb + NS2 - 1);
        else cp_async_commit();
        const int st = jb % NS2;
        if (tid * 16 < nc) {
#pragma unroll
          for (int r2 = 0; r2 < JB; ++r2) {
            const int4 raw =
                *reinterpret_cast<const int4*>(&sm.u.w2[st][r2][tid * 16]);
            const int8_t* wv = reinterpret_cast<const int8_t*>(&raw);
            float w[16];
#pragma unroll
            for (int t = 0; t < 16; ++t) w[t] = (float)wv[t];
            const int j = jb * JB + r2;
#pragma unroll
            for (int r = 0; r < MT; ++r) {
              const float hv = sm.hs[m0 + r][j];
#pragma unroll
              for (int t = 0; t < 16; ++t) acc[r][t] = fmaf(hv, w[t], acc[r][t]);
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every stage is read before the next pass refills
      if (tid * 16 < nc) {
        float* wsb = ws + (long long)blockIdx.x * M * N + n0 + tid * 16;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int m = m0 + r;
          if (m < M) {
#pragma unroll
            for (int t = 0; t < 16; t += 4)
              *reinterpret_cast<float4*>(wsb + (long long)m * N + t) =
                  make_float4(acc[r][t], acc[r][t + 1], acc[r][t + 2],
                              acc[r][t + 3]);
          }
        }
      }
    }
  }
}

template <int MT>
int launch_hidden(const void* x, const void* w1, const void* s1,
                  const void* b1, const void* w2, void* ws, int M, int K,
                  int H, int N, int act, cudaStream_t st) {
  const int smem = (int)sizeof(Smem<MT>);
  cudaError_t err = cudaFuncSetAttribute(
      int8_mlp_hidden_kernel<MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int8_mlp_hidden_kernel<MT><<<H / BH, NT, smem, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w1, (const float*)s1,
      (const float*)b1, (const int8_t*)w2, (float*)ws, M, K, H, N, act);
  return (int)cudaGetLastError();
}

}  // namespace otter
