// Packed-int4 weight-only products for Hopper (sm_90a), two weights a byte,
// values in [-7, 7], unpacked in registers:
//
//   int4_mlp:    h = round_x(act((x @ unpack0(W1p)) * s1)),
//                y = (h @ unpack1(W2p)) * s2
//                x [M, K] bf16 (M <= 32, K % 32 == 0), W1p [K/2, H],
//                s1 [H] f32, W2p [H, N/2], s2 [N] f32; y [M, N] bf16;
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
// [p, p + R) multiplies them with two slices of x, columns [p, p + R) for
// the low nibbles and [K/2 + p, K/2 + p + R) for the high ones, and the
// two nibbles of a packed W2 byte are output columns o and o + N/2.
// Partial outputs of the CTAs go to an f32 workspace and a second small
// launch (mlp_common.cuh) sums them in a fixed order, scales and casts:
// no atomics, so the result is the same from run to run.
//
// What bounds them on the H100: at decode (M <= 32) they read 0.5 byte a
// weight once (67 MB for the MPT-7B MLP, 25 MB for its qkv projection) for
// 2 M multiply-adds a weight, so they are bound by bytes: what must stay
// low is the instructions a weight byte, and what must stay high is the
// bytes in flight.
//
// int4_mlp, the design of int8_mlp_kernel.cuh with nibbles: CTA j owns
// hidden units [128 j, 128 j + 128), 8 warps.
// - Products on the tensor cores: mma.sync m16n8k16 in bf16 with the
//   operands swapped, a 16-column weight tile as A and the M <= 32 rows of
//   x (phase 1) or of the bf16 hidden block (phase 2) as 1 to 4 n-tiles of
//   B, inside the tile loop: every packed byte is read once a call, at any
//   M. Nibbles become bf16 in registers, exactly and without I2F: a byte
//   permute, a lop3 and a bf16x2 subtraction a pair (int4_mma.cuh).
// - Phase 1: one load of four words gives two k steps (the low nibbles
//   against x's columns p, the high ones against K/2 + p) of two tiles.
//   Warp w takes hidden units 32 (w % 4) .. + 31 over half the rows of
//   every stage (w / 4); the halves are added in a fixed order, scaled by
//   s1, activated and rounded to bf16 into shared memory.
// - Phase 2: one load gives four tiles, output columns o (low nibbles) and
//   N/2 + o (high) of one k step. Warp w takes packed columns 32 w .. + 31
//   of every stage over the CTA's 128 hidden rows and stores its sums to
//   the CTA's workspace slice.
// - One cp.async ring of 32 KB slots for both phases (phase 1: packed rows
//   of W1p with x's two slices; phase 2: 128 rows of W2p), five slots in
//   flight, so W2p's first stages arrive while phase 1 ends. A grid of
//   more CTAs than SMs (falcon7b's 142) runs three slots a CTA and two
//   CTAs an SM: no second wave.
// - The sum of the H/128 partial outputs is a programmatic dependent
//   launch of 8 warps a 32-value block (`sum_partials_grouped_kernel`),
//   scheduled once phase 2 begins: one thread a value would wait on 128
//   loads in turn where M N is small.
// int4_matmul, on the CUDA cores: CTA (j, s) owns output columns
//   [128 j, 128 j + 128) and the s-th run of packed rows; W1p's column
//   block streams in stages of 64 packed rows, three in flight; a nibble
//   becomes an f32 by a shift, a logic op and a subtraction (written into
//   the mantissa of 2^23); each of the 8 warps sums 8 packed rows of every
//   stage for 4 columns a lane, and the warps' sums are added in a fixed
//   order into ws[s].
#include "int4_mma.cuh"
#include "mlp_common.cuh"

namespace {

using namespace otter;

constexpr int BH = 128;    // columns (int4_matmul) or hidden units a CTA
constexpr int NT = 256;    // threads per CTA: 8 warps
constexpr int MMAX = 32;   // largest M (decode shapes)
constexpr int KC = 64;     // packed rows per pipeline stage (128 weight rows)
constexpr int NS1 = 3;     // packed-row product: stages in flight
constexpr int KG = NT / 32;  // packed-row product: row groups, one warp each

// ── int4_mlp: the fused MLP on the tensor cores ──

constexpr int SLOT = 32 * 1024;  // ring slot bytes, either phase
constexpr int C2P = 256;         // phase 2: packed W2 columns a stage (x BH)

// Shared memory with NB n-tiles (M <= 8 NB) and NS ring slots: each slot
// holds, in phase 1, R1 packed rows of W1p's BH columns, then x's 8 NB rows
// of the two matching R1-column slices (the low nibbles' columns p, then
// the high nibbles' K/2 + p; R1: the most, in whole 32-row steps, that fit
// a slot with them), in phase 2 the CTA's BH rows of C2P packed W2
// columns; after the slots, the bf16 hidden block hs [8 NB][BH].
template <int NB, int NS>
struct Int4Layout {
  static constexpr int R1 = SLOT / (BH + 32 * NB) / 32 * 32;
  static constexpr int XOFF = R1 * BH;
  static constexpr int XROW = 2 * R1 * 2;
  static constexpr int HS = NS * SLOT;
  static constexpr int BYTES = HS + 8 * NB * BH * 2;
  static_assert(XOFF + 8 * NB * XROW <= SLOT && BH * C2P <= SLOT, "slot");
};

template <int NB, int NS>
__global__ void __launch_bounds__(NT, NS <= 3 ? 2 : 1) int4_mlp_hidden_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w1,
    const float* __restrict__ s1, const int8_t* __restrict__ w2,
    float* __restrict__ ws, int M, int K, int H, int N, int act) {
  using L = Int4Layout<NB, NS>;
  constexpr int R1 = L::R1, XC = R1 / 8;   // XC: 16-byte chunks of a slice
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int j0 = blockIdx.x * BH;
  const int k2 = K / 2, n2 = N / 2;
  const int n1 = (k2 + R1 - 1) / R1, nw2 = (n2 + C2P - 1) / C2P;
  unsigned char* hs = smem + L::HS;

  // stage i of the stream (W1p's n1, then W2p's nw2) into slot i % NS,
  // chunks swizzled by `w_chunk` / `x_chunk`; past K/2 or N/2, zeros
  auto load = [&](int i) {
    unsigned char* st = smem + (i % NS) * SLOT;
    if (i < n1) {
      const int p0 = i * R1;
      for (int e = tid; e < R1 * (BH / 16); e += NT) {
        const int r = e >> 3, c = e & 7;
        const bool ok = p0 + r < k2;
        cp_async16(st + r * BH + w_chunk(r, c),
                   ok ? w1 + (long long)(p0 + r) * H + j0 + c * 16 : w1, ok);
      }
      for (int e = tid; e < 8 * NB * 2 * XC; e += NT) {
        const int m = e / (2 * XC), c = e % (2 * XC);
        const int hi = c >= XC, col = p0 + (c - hi * XC) * 8;
        const bool ok = m < M && col < k2;
        cp_async16(st + L::XOFF + m * L::XROW + x_chunk(m, c),
                   ok ? x + (long long)m * K + hi * k2 + col : x, ok);
      }
    } else if (i < n1 + nw2) {
      const int c0 = (i - n1) * C2P;
      for (int e = tid; e < BH * (C2P / 16); e += NT) {
        const int r = e >> 4, c = e & 15;
        const bool ok = c0 + c * 16 < n2;
        cp_async16(st + r * C2P + w_chunk(r, c),
                   ok ? w2 + (long long)(j0 + r) * n2 + c0 + c * 16 : w2, ok);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) load(s);

  // phase 1: warp w takes hidden units 32 hg .. + 31 over half kh of the
  // packed rows of every stage; a thread's quad is units 32 hg + 4 g .. + 3
  const int hg = warp & 3, kh = warp >> 2;
  {
    float acc[2][NB][4];
#pragma unroll
    for (int tl = 0; tl < 2; ++tl)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[tl][n][c] = 0.f;
    const int wcol = w_quad(hg, g, t), r0 = kh * (R1 / 2);
    for (int i = 0; i < n1; ++i) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      // the slot refilled here was read in the previous iteration
      load(i + NS - 1);
      const unsigned char* st = smem + (i % NS) * SLOT;
      int4_k_steps_rows<NB, BH, L::XROW, R1 / 32>(
          st, r0, wcol, st + L::XOFF, r0, R1 + r0, g, t, acc);
    }
    // the two row halves are added in a fixed order, through the slot
    // phase 1 read last (refilled only after the next barrier but one)
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem + ((n1 - 1) % NS) * SLOT);
    // hidden unit 32 hg + 4 g + 2 tl + c / 2 of row 8 n + 2 t + c % 2
    if (kh == 1) {
#pragma unroll
      for (int tl = 0; tl < 2; ++tl)
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            red[(8 * n + 2 * t + (c & 1)) * BH + 32 * hg + 4 * g + 2 * tl +
                (c >> 1)] = acc[tl][n][c];
    }
    __syncthreads();
    if (kh == 0) {
#pragma unroll
      for (int tl = 0; tl < 2; ++tl)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 32 * hg + 4 * g + 2 * tl + (c >> 1);
          const float sc = s1[j0 + j];
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const int m = 8 * n + 2 * t + (c & 1);
            const float z = __fmul_rn(acc[tl][n][c] + red[m * BH + j], sc);
            *reinterpret_cast<__nv_bfloat16*>(
                hs + m * (BH * 2) + x_chunk(m, j >> 3) + 2 * (j & 7)) =
                __float2bfloat16(apply_act(z, act));
          }
        }
    }
    __syncthreads();
  }
  // the sum of the partial outputs may be scheduled now (it waits for
  // this grid's end before it reads)
  pdl_launch_dependents();

  // phase 2: warp w takes packed columns 32 w .. + 31 of every stage over
  // the CTA's BH hidden rows; its low nibbles are output columns o, its
  // high ones N/2 + o
  const int wcol2 = w_quad(warp, g, t);
  for (int i = n1; i < n1 + nw2; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    load(i + NS - 1);
    const unsigned char* st = smem + (i % NS) * SLOT;
    float acc[2][2][NB][4];
#pragma unroll
    for (int nib = 0; nib < 2; ++nib)
#pragma unroll
      for (int tl = 0; tl < 2; ++tl)
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[nib][tl][n][c] = 0.f;
    int4_k_steps_cols<NB, C2P, BH * 2, BH / 16>(st, wcol2, hs, g, t, acc);
    // column o + q of row 8 n + 2 t + e: acc[nib][q / 2][n][2 (q % 2) + e]
    const int o = (i - n1) * C2P + 32 * warp + 4 * g;
    if (o < n2) {
      float* dst = ws + (long long)blockIdx.x * M * N + o;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * n + 2 * t + e;
          if (m < M) {
#pragma unroll
            for (int nib = 0; nib < 2; ++nib)
              *reinterpret_cast<float4*>(dst + (long long)m * N + nib * n2) =
                  make_float4(acc[nib][0][n][e], acc[nib][0][n][2 + e],
                              acc[nib][1][n][e], acc[nib][1][n][2 + e]);
          }
        }
    }
  }
  cp_async_wait<0>();
}

template <int NB, int NS>
int launch_hidden_ns(const void* x, const void* w1, const void* s1,
                     const void* w2, void* ws, int M, int K, int H, int N,
                     int act, cudaStream_t st) {
  constexpr int smem = Int4Layout<NB, NS>::BYTES;
  auto kernel = int4_mlp_hidden_kernel<NB, NS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return launch_kernel(false, kernel, dim3(H / BH), NT, smem, st,
                       (const __nv_bfloat16*)x, (const int8_t*)w1,
                       (const float*)s1, (const int8_t*)w2, (float*)ws, M, K,
                       H, N, act);
}

// six slots (five in flight) for a grid of one wave; for more CTAs than
// SMs (falcon7b's 142), three slots and two CTAs an SM: as many bytes in
// flight an SM, and no second wave
template <int NB>
int launch_hidden_nb(const void* x, const void* w1, const void* s1,
                     const void* w2, void* ws, int M, int K, int H, int N,
                     int act, cudaStream_t st) {
  static_assert(2 * (Int4Layout<NB, 3>::BYTES + 1024) <= 228 * 1024, "2/SM");
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (H / BH > sms)
    return launch_hidden_ns<NB, 3>(x, w1, s1, w2, ws, M, K, H, N, act, st);
  return launch_hidden_ns<NB, 6>(x, w1, s1, w2, ws, M, K, H, N, act, st);
}

// ceil(M / 8) n-tiles: the weights stream once for any M <= MMAX
int launch_hidden(const void* x, const void* w1, const void* s1,
                  const void* w2, void* ws, int M, int K, int H, int N,
                  int act, cudaStream_t st) {
  switch ((M + 7) / 8) {
    case 1: return launch_hidden_nb<1>(x, w1, s1, w2, ws, M, K, H, N, act, st);
    case 2: return launch_hidden_nb<2>(x, w1, s1, w2, ws, M, K, H, N, act, st);
    case 3: return launch_hidden_nb<3>(x, w1, s1, w2, ws, M, K, H, N, act, st);
    default:
      return launch_hidden_nb<4>(x, w1, s1, w2, ws, M, K, H, N, act, st);
  }
}

// ── int4_matmul: the packed-row product on the CUDA cores ──

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
  if (M < 1 || M > MMAX || K % 32 != 0 || H % BH != 0 || N % 32 != 0 ||
      act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_hidden(x, w1, s1, w2, ws, M, K, H, N, act, st);
  if (err != 0) return err;
  return launch_sum_partials_grouped(ws, s2, out, M, N, H / BH, st,
                                     /*pdl=*/true);
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
