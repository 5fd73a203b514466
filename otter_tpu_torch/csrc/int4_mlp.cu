// Packed-int4 weight-only products for Hopper (sm_90a), two weights a byte,
// values in [-7, 7], unpacked in registers:
//
//   int4_mlp:    h = round_x(act((x @ unpack0(W1p)) * s1)),
//                y = (h @ unpack1(W2p)) * s2
//                x [M, K] bf16 (M <= 32), W1p [K/2, H], s1 [H] f32,
//                W2p [H, N/2], s2 [N] f32; y [M, N] bf16;
//                ws is f32 scratch [H/128, M, N].
//   int4_matmul: y = (x @ unpack0(Wp)) * scale
//                x [M, K] bf16 (M <= 32), Wp [K/2, N], scale [N] f32;
//                y [M, N] bf16; ws is f32 scratch [splits, M, N].
//
// Packing (otter_tpu_torch/ops/quant.py:quantize_kernel_int4), half and half:
//   unpack0: byte[i, o] = w[i, o] | w[i + K/2, o] << 4   (pairs of rows)
//   unpack1: byte[i, o] = w[i, o] | w[i, o + N/2] << 4   (pairs of columns)
//
// Replace the Pallas TPU kernels otter_tpu/ops/quant.py:int4_mlp and
// otter_tpu/ops/quant.py:int4_matmul (the kernel bodies passed to
// pallas_call there). The TPU kernels walk their grid in order, unpack a
// whole block with one concat, and give every block the full K so that
// both nibbles of a byte are at hand. Here a CTA that streams packed rows
// [p, p + 64) multiplies them with two slices of x, columns [p, p + 64)
// for the low nibbles and [K/2 + p, K/2 + p + 64) for the high ones, so K
// can be split among CTAs (int4_matmul does, to fill the card); and a
// thread that holds 8 bytes of packed W2 owns 8 output columns at o and 8
// at o + N/2. Partial outputs of the CTAs go to an f32 workspace and a
// second small launch (mlp_common.cuh) sums them in a fixed order, scales
// and casts: no atomics, so the result is the same from run to run.
//
// What bounds them on the H100: at decode (M <= 32) they read 0.5 byte a
// weight once (67 MB for the MPT-7B MLP, 25 MB for its qkv projection) for
// 2 M multiply-adds a weight, so they are bound by bytes. The design reads
// every packed byte once through cp.async pipelines, turns a nibble into
// an f32 with one shift, one logic op and one subtraction (the nibble is
// written into the mantissa of 2^23), and keeps the hidden activation in
// shared memory. The products run on the CUDA cores in f32.
//
// int4_mlp: CTA j owns hidden units [128 j, 128 j + 128), 256 threads.
//   Phase 1 (shared with int4_matmul, packed_block_product): W1p's
//   128-column block streams through shared memory in stages of 64 packed
//   rows (128 weight rows), three in flight, with the two matching slices
//   of x; each of the 8 warps sums 8 packed rows of every stage for 4
//   columns a lane; the warps' partial sums are added in a fixed order,
//   scaled by s1, activated and rounded to bf16 into shared memory.
//   Phase 2: W2p's 128-row block streams in 8-row stages of up to 2048
//   packed columns, four in flight; each thread owns 8 packed columns (16
//   outputs) and stores its partial sums in the CTA's workspace slice.
// int4_matmul: CTA (j, s) owns output columns [128 j, 128 j + 128) and the
//   s-th run of packed rows; phase 1 as above, partial sums to ws[s].
#include "mlp_common.cuh"

namespace {

using namespace otter;

constexpr int BH = 128;    // columns of the packed-row product per CTA
constexpr int NT = 256;    // threads per CTA
constexpr int MMAX = 32;   // largest M (decode shapes)
constexpr int KC = 64;     // packed rows per pipeline stage (128 weight rows)
constexpr int NS1 = 3;     // packed-row product: stages in flight
constexpr int KG = NT / 32;  // packed-row product: row groups, one warp each
constexpr int JB = 8;      // MLP phase 2: W2p rows per pipeline stage
constexpr int NCP = 2048;  // MLP phase 2: packed columns per pass (NT * 8)
constexpr int NS2 = 4;     // MLP phase 2: stages in flight

// nibble `i` (0 = lowest) of a word as a float in [-8, 7]: (n ^ 8) lands in
// the mantissa of 2^23, and 2^23 + (n ^ 8) - (2^23 + 8) = n sign-extended
__device__ __forceinline__ float nibble(uint32_t word, int i) {
  return __uint_as_float(((word >> (4 * i)) & 0xFu) ^ 0x4B000008u) -
         8388616.f;
}

template <int MT>
union Phase1 {
  struct {
    int8_t w[NS1][KC][BH];             // packed rows
    __nv_bfloat16 x[NS1][2][MT][KC];   // x for the low / the high nibbles
  } st;
  float red[KG][MT][BH];   // each row group's partial sums
};

// red[g][r][c] = the g-th row group's share of
//   x[m0 + r, :] @ unpack0(w)[rows, j0 + c]
// over the packed rows [p0, p0 + np) of w [K/2, ldw] (np a multiple of KC),
// i.e. weight rows [p0, p0 + np) and [K/2 + p0, K/2 + p0 + np). Rows of x
// past M count as zero. Ends with the CTA synchronized on a filled `red`;
// the caller adds the KG groups in order and synchronizes before the next
// call.
template <int MT>
__device__ __forceinline__ void packed_block_product(
    Phase1<MT>& sm, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, int M, int K, int ldw, int j0, int m0,
    int p0, int np) {
  const int tid = threadIdx.x;
  // warp kg sums packed rows kg*8..kg*8+7 of every stage for the 4
  // columns c4..c4+3
  const int kg = tid / 32, c4 = (tid % 32) * 4;
  const int nk = np / KC;
  auto load = [&](int stage, int kc) {
    const int pk = p0 + kc * KC;
    for (int e = tid; e < KC * (BH / 16); e += NT) {
      const int r = e / (BH / 16), cv = e % (BH / 16);
      cp_async16(&sm.st.w[stage][r][cv * 16],
                 w + (long long)(pk + r) * ldw + j0 + cv * 16, true);
    }
    for (int e = tid; e < 2 * MT * (KC / 8); e += NT) {
      const int half = e / (MT * (KC / 8)), r = (e / (KC / 8)) % MT,
                cv = e % (KC / 8), m = m0 + r;
      const bool ok = m < M;
      cp_async16(&sm.st.x[stage][half][r][cv * 8],
                 ok ? x + (long long)m * K + half * (K / 2) + pk + cv * 8 : x,
                 ok);
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
    if (s < nk) load(s, s);
    else cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<NS1 - 2>();
    __syncthreads();
    // the stage refilled here was consumed in the previous iteration
    if (kc + NS1 - 1 < nk) load((kc + NS1 - 1) % NS1, kc + NS1 - 1);
    else cp_async_commit();
    const int cur = kc % NS1;
#pragma unroll
    for (int kk = kg * (KC / KG); kk < (kg + 1) * (KC / KG); ++kk) {
      const uint32_t p =
          *reinterpret_cast<const uint32_t*>(&sm.st.w[cur][kk][c4]);
      float lo[4], hi[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        lo[t] = nibble(p, 2 * t);
        hi[t] = nibble(p, 2 * t + 1);
      }
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float xl = __bfloat162float(sm.st.x[cur][0][r][kk]);
        const float xh = __bfloat162float(sm.st.x[cur][1][r][kk]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[r][t] = fmaf(xl, lo[t], acc[r][t]);
          acc[r][t] = fmaf(xh, hi[t], acc[r][t]);
        }
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
}

template <int MT>
struct MlpSmem {
  float hs[MMAX][BH];   // bf16-rounded hidden activations
  union {
    Phase1<MT> p1;
    int8_t w2[NS2][JB][NCP];
  } u;
};

template <int MT>
__global__ void __launch_bounds__(NT) int4_mlp_hidden_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w1,
    const float* __restrict__ s1, const int8_t* __restrict__ w2,
    float* __restrict__ ws, int M, int K, int H, int N, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MlpSmem<MT>& sm = *reinterpret_cast<MlpSmem<MT>*>(smem_raw);
  const int j0 = blockIdx.x * BH;
  const int tid = threadIdx.x;

  for (int e = tid; e < MMAX * BH; e += NT) sm.hs[e / BH][e % BH] = 0.f;

  // phase 1: hidden block = act(x @ unpack0(W1p)[:, j0:j0+BH] * s1),
  // bf16-rounded
  for (int m0 = 0; m0 < M; m0 += MT) {
    packed_block_product<MT>(sm.u.p1, x, w1, M, K, H, j0, m0, 0, K / 2);
    // the row groups are added in a fixed order: the result is reproducible
    for (int e = tid; e < MT * BH; e += NT) {
      const int r = e / BH, col = e % BH, m = m0 + r;
      if (m >= M) continue;
      float z = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g) z += sm.u.p1.red[g][r][col];
      z *= s1[j0 + col];
      sm.hs[m][col] = __bfloat162float(__float2bfloat16(apply_act(z, act)));
    }
    __syncthreads();
  }

  // phase 2: ws[blk, :, n] = hidden block @ unpack1(W2p)[j0:j0+BH, n]; each
  // thread owns 8 packed columns of a 2048-column pass: outputs
  // [o, o + 8) from the low nibbles and [N/2 + o, N/2 + o + 8) from the
  // high ones
  constexpr int NJ = BH / JB;
  const int n2 = N / 2;
  for (int m0 = 0; m0 < M; m0 += MT) {
    for (int n0 = 0; n0 < n2; n0 += NCP) {
      const int nc = min(NCP, n2 - n0);
      auto load2 = [&](int stage, int jb) {
        for (int e = tid; e < JB * (nc / 16); e += NT) {
          const int r = e / (nc / 16), cv = e % (nc / 16);
          cp_async16(&sm.u.w2[stage][r][cv * 16],
                     w2 + (long long)(j0 + jb * JB + r) * n2 + n0 + cv * 16,
                     true);
        }
        cp_async_commit();
      };
      float acc[MT][16];   // [r][0..7] low nibbles, [r][8..15] high
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
        if (tid * 8 < nc) {
#pragma unroll
          for (int r2 = 0; r2 < JB; ++r2) {
            const uint2 raw =
                *reinterpret_cast<const uint2*>(&sm.u.w2[st][r2][tid * 8]);
            float wv[16];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              wv[t] = nibble(raw.x, 2 * t);
              wv[4 + t] = nibble(raw.y, 2 * t);
              wv[8 + t] = nibble(raw.x, 2 * t + 1);
              wv[12 + t] = nibble(raw.y, 2 * t + 1);
            }
            const int j = jb * JB + r2;
#pragma unroll
            for (int r = 0; r < MT; ++r) {
              const float hv = sm.hs[m0 + r][j];
#pragma unroll
              for (int t = 0; t < 16; ++t)
                acc[r][t] = fmaf(hv, wv[t], acc[r][t]);
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every stage is read before the next pass refills
      if (tid * 8 < nc) {
        float* wsb = ws + (long long)blockIdx.x * M * N + n0 + tid * 8;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int m = m0 + r;
          if (m < M) {
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
              for (int t = 0; t < 8; t += 4)
                *reinterpret_cast<float4*>(wsb + (long long)m * N +
                                           half * n2 + t) =
                    make_float4(acc[r][8 * half + t], acc[r][8 * half + t + 1],
                                acc[r][8 * half + t + 2],
                                acc[r][8 * half + t + 3]);
          }
        }
      }
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(NT) int4_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    float* __restrict__ ws, int M, int K, int N) {
  __shared__ __align__(16) Phase1<MT> sm;
  const int j0 = blockIdx.x * BH;
  const int np = (K / 2) / gridDim.y;
  for (int m0 = 0; m0 < M; m0 += MT) {
    packed_block_product<MT>(sm, x, w, M, K, N, j0, m0, blockIdx.y * np, np);
    for (int e = threadIdx.x; e < MT * BH; e += NT) {
      const int r = e / BH, col = e % BH, m = m0 + r;
      if (m >= M) continue;
      float z = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g) z += sm.red[g][r][col];
      ws[((long long)blockIdx.y * M + m) * N + j0 + col] = z;
    }
    __syncthreads();
  }
}

template <int MT>
int launch_mlp_hidden(const void* x, const void* w1, const void* s1,
                      const void* w2, void* ws, int M, int K, int H, int N,
                      int act, cudaStream_t st) {
  const int smem = (int)sizeof(MlpSmem<MT>);
  cudaError_t err = cudaFuncSetAttribute(
      int4_mlp_hidden_kernel<MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int4_mlp_hidden_kernel<MT><<<H / BH, NT, smem, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w1, (const float*)s1,
      (const int8_t*)w2, (float*)ws, M, K, H, N, act);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_matmul(const void* x, const void* w, void* ws, int M, int K,
                  int N, int splits, cudaStream_t st) {
  int4_matmul_kernel<MT><<<dim3(N / BH, splits), NT, 0, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (float*)ws, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int int4_mlp_bf16(const void* x, const void* w1, const void* s1,
                             const void* w2, const void* s2, void* ws,
                             void* out, int M, int K, int H, int N, int act,
                             void* stream) {
  if (M < 1 || M > MMAX || K % (2 * KC) != 0 || H % BH != 0 || N % 32 != 0 ||
      act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = M == 1
      ? launch_mlp_hidden<1>(x, w1, s1, w2, ws, M, K, H, N, act, st)
      : launch_mlp_hidden<8>(x, w1, s1, w2, ws, M, K, H, N, act, st);
  if (err != 0) return err;
  return launch_sum_partials(ws, s2, nullptr, out, M, N, H / BH, st);
}

extern "C" int int4_matmul_bf16(const void* x, const void* w,
                                const void* scale, void* ws, void* out, int M,
                                int K, int N, int splits, void* stream) {
  if (M < 1 || M > MMAX || N % BH != 0 || splits < 1 ||
      (K / 2) % (KC * splits) != 0 || K % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = M == 1 ? launch_matmul<1>(x, w, ws, M, K, N, splits, st)
                         : launch_matmul<8>(x, w, ws, M, K, N, splits, st);
  if (err != 0) return err;
  return launch_sum_partials(ws, scale, nullptr, out, M, N, splits, st);
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
