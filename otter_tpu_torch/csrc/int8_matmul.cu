// Streamed int8 weight-only product for Hopper (sm_90a):
//   out = bf16((x @ Wq) * scale)
// x [M, K] bf16 (1 <= M <= 32, K % 64 == 0), Wq [K, N] int8 with row stride
// ldw >= N (any N >= 1, any stride, any base address), scale [N] f32,
// out [M, N] bf16. The decode-shaped product of an untied int8 lm_head: N is
// the vocabulary (32002 for LLaMA-2 with its two added tokens, 262144 for
// Fuyu), K the model width.
//
// Replaces the Pallas TPU kernel otter_tpu/ops/quant.py:int8_matmul (the
// kernel body passed to pallas_call there), with its arithmetic: the int8
// weight is converted after the load (exact in bf16 and in f32), products
// are accumulated in f32 over all of K, multiplied by the scale in f32 and
// rounded once to bf16. Its tiling is not carried over: the TPU kernel walks
// a (N / block_out, K / block_in) grid in order with an accumulator in VMEM,
// pads M to 8 sublanes and needs a block_out that divides N (at N = 32002
// that search ends at 2 columns a block). Here one CTA owns 128 columns,
// runs the whole K loop itself and writes its columns once: no workspace, no
// second launch, no atomics, one fixed order of summation, so a result is
// the same from run to run. N / 128 is 251 CTAs for LLaMA's head and 2048
// for Fuyu's, against 132 SMs.
//
// What bounds it on the H100: it reads K * N int8 weights once (131 MB and
// 1.07 GB) for 2 M operations a weight with M <= 32, far below the ~295
// operations a byte where the tensor cores would be the limit: bound by
// bytes. The design reads every weight once at 1 byte and converts it in
// registers.
//
// Rows that are not 16-byte aligned. With N = 32002 only every 8th weight row
// starts on a 16-byte boundary, and a 128-column block of a row never does in
// general, so 16-byte loads cannot start at the block's first column. Each
// row's block is therefore fetched from the 16-byte boundary at or below its
// first byte: nine 16-byte cp.async vectors cover the 128 wanted bytes at any
// shift, land in a 144-byte row of shared memory, and the readers add the
// row's shift (address & 15, the same for a whole warp) when they pick their
// four bytes out of two 32-bit words (funnel shift). An aligned weight
// (N % 16 == 0, Fuyu's) has shift 0 everywhere and its ninth vector is never
// asked for. A vector that would reach before the weight's first byte or past
// its last is filled byte by byte with guards instead (only the first and the
// last row can meet that); vectors wholly past the block's last wanted column
// are zeroed. Columns past N in the last block are computed on whatever the
// vectors brought (bytes of the next row) and never written.
//
// Design: 256 threads; the block streams through shared memory in 64-row
// stages, three in flight (cp.async: the loads of the next stages overlap the
// multiply-adds of this one) with the matching slice of x; warp g sums rows
// 8 g .. 8 g + 7 of every stage for 4 columns a lane over MT rows of x at a
// time (MT = 1, 8, 16 or 32, the smallest that holds M, so the weight is
// streamed once whatever M is); the warps' sums are added in order, scaled
// and stored. int8 -> f32 goes through one byte permute and one subtract a
// weight (the byte, biased by 128, is placed in the mantissa of 2^23), not
// through the slower integer conversion. The products run on the CUDA cores
// in f32 in this first version.
#include "mlp_common.cuh"

using namespace otter;

namespace {

constexpr int QB = 128;        // output columns per CTA
constexpr int QNT = 256;       // threads per CTA
constexpr int QKC = 64;        // weight rows per pipeline stage
constexpr int QNS = 3;         // stages in flight
constexpr int QKG = QNT / 32;  // row groups of a stage, one warp each
constexpr int QWS = QB + 16;   // bytes of a shared-memory weight row
constexpr int QNV = QWS / 16;  // 16-byte vectors of such a row
constexpr int QMAX = 32;       // largest M

template <int MT>
union HeadSmem {
  struct {
    int8_t w[QNS][QKC][QWS];
    __nv_bfloat16 x[QNS][MT][QKC];
  } st;
  float red[QKG][MT < 8 ? MT : 8][QB];   // the row groups' partial sums
};

// float(b) of the signed byte `sel` of u, where u holds bytes b ^ 0x80:
// 0x4B0000uu is 2^23 + uu as a float, and uu = b + 128.
__device__ __forceinline__ float byte_to_float(uint32_t u, uint32_t sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
}

template <int MT>
__global__ void __launch_bounds__(QNT) int8_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
    int K, int N, long long ldw) {
  __shared__ __align__(16) HeadSmem<MT> sm;
  const int tid = threadIdx.x;
  const int kg = tid / 32, c4 = (tid % 32) * 4;
  const int j0 = blockIdx.x * QB;
  const int nc = min(QB, N - j0);           // wanted columns of this block
  const int8_t* wj = w + j0;                // the block's byte of row 0
  const int8_t* w_end = w + (long long)(K - 1) * ldw + N;
  const int nk = K / QKC;
  // the shift of row k is (a0 + k * l15) & 15
  const int a0 = (int)(reinterpret_cast<uintptr_t>(wj) & 15);
  const int l15 = (int)(ldw & 15);

  auto load = [&](int stage, int kc) {
    const int k0 = kc * QKC;
    for (int e = tid; e < QKC * QNV; e += QNT) {
      const int r = e / QNV, v = e % QNV;
      const int8_t* a = wj + (long long)(k0 + r) * ldw;
      const int8_t* src = a - (reinterpret_cast<uintptr_t>(a) & 15) + v * 16;
      int8_t* dst = &sm.st.w[stage][r][v * 16];
      if (src >= a + nc) {
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
      } else if (src >= w && src + 16 <= w_end) {
        cp_async16(dst, src, true);
      } else {
        for (int t = 0; t < 16; ++t) {
          const int8_t* p = src + t;
          dst[t] = (p >= w && p < w_end) ? *p : (int8_t)0;
        }
      }
    }
    for (int e = tid; e < MT * (QKC / 8); e += QNT) {
      const int r = e / (QKC / 8), cv = e % (QKC / 8);
      const bool ok = r < M;
      cp_async16(&sm.st.x[stage][r][cv * 8],
                 ok ? x + (long long)r * K + k0 + cv * 8 : x, ok);
    }
    cp_async_commit();
  };

  float acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[r][t] = 0.f;
#pragma unroll
  for (int s = 0; s < QNS - 1; ++s) {
    if (s < nk) load(s, s);
    else cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<QNS - 2>();
    __syncthreads();
    // the stage refilled here was consumed in the previous iteration
    if (kc + QNS - 1 < nk) load((kc + QNS - 1) % QNS, kc + QNS - 1);
    else cp_async_commit();
    const int cur = kc % QNS;
#pragma unroll
    for (int kk = kg * (QKC / QKG); kk < (kg + 1) * (QKC / QKG); ++kk) {
      const int pos = ((a0 + ((kc * QKC + kk) & 15) * l15) & 15) + c4;
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(&sm.st.w[cur][kk][0]);
      const uint32_t u =
          __funnelshift_r(row[pos >> 2], row[(pos >> 2) + 1], (pos & 3) * 8) ^
          0x80808080u;
      const float w0 = byte_to_float(u, 0x7650), w1 = byte_to_float(u, 0x7651),
                  w2 = byte_to_float(u, 0x7652), w3 = byte_to_float(u, 0x7653);
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

  constexpr int RC = MT < 8 ? MT : 8;   // rows of x per reduction round
#pragma unroll
  for (int r0 = 0; r0 < MT; r0 += RC) {
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) sm.red[kg][r][c4 + t] = acc[r0 + r][t];
    __syncthreads();
    for (int e = tid; e < RC * QB; e += QNT) {
      const int r = e / QB, col = e % QB, m = r0 + r;
      if (m >= M || col >= nc) continue;
      float z = 0.f;
#pragma unroll
      for (int g = 0; g < QKG; ++g) z += sm.red[g][r][col];
      out[(long long)m * N + j0 + col] = __float2bfloat16(z * scale[j0 + col]);
    }
    __syncthreads();   // red is read before the next round overwrites it
  }
}

template <int MT>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int K, int N, long long ldw, cudaStream_t st) {
  int8_matmul_kernel<MT><<<(N + QB - 1) / QB, QNT, 0, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale,
      (__nv_bfloat16*)out, M, K, N, ldw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int int8_matmul_bf16(const void* x, const void* w,
                                const void* scale, void* out, int M, int K,
                                int N, long long ldw, void* stream) {
  if (M < 1 || M > QMAX || K < QKC || K % QKC != 0 || N < 1 || ldw < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (M == 1) return launch<1>(x, w, scale, out, M, K, N, ldw, st);
  if (M <= 8) return launch<8>(x, w, scale, out, M, K, N, ldw, st);
  if (M <= 16) return launch<16>(x, w, scale, out, M, K, N, ldw, st);
  return launch<32>(x, w, scale, out, M, K, N, ldw, st);
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
