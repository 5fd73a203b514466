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
// bytes in flight. A single projection is short (25 MB is 7.5 us at the
// memory's rate, MPT-7B's out-projection 2.5 us), so the time it takes to
// get the first bytes of every CTA in flight counts too.
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
// int4_matmul, int4_mlp's phase 1 without the activation, on the tensor
// cores with the same fragments: CTA (j, s) owns output columns
// [128 j, 128 j + 128) and the s-th run of packed rows (the host's plan,
// ops/quant.py:split_k, puts 256-384 CTAs on the card for MPT-7B's
// projections: 96 and 32 column blocks alone would leave most SMs idle).
// - The M <= 32 rows of x are 1 to 4 B n-tiles inside the tile loop, so
//   every packed byte is read once a call at any M (the CUDA-core version
//   walked M in chunks of 8 and read the weight four times at M = 32).
// - Stages of 64 packed rows (8 KB) through a cp.async ring of six slots,
//   one commit group a stage, so that a CTA's products start when its
//   first stage lands (a CTA streams only 4 to 8 stages): 5 stages, 40 KB,
//   in flight a CTA, three CTAs an SM at M <= 8. One group for the first
//   five stages was 9-21% slower on the H100, and so were twice the
//   splits; four slots changed nothing, eight were slower at M = 32.
// - Warp w takes columns 32 (w % 4) .. + 31 over half w / 4 of every
//   stage's packed rows; the halves are added in a fixed order through
//   shared memory and written to the CTA's workspace slice, and the sum of
//   the slices is a programmatic dependent launch of
//   `sum_partials_grouped_kernel`, scheduled once the products are done.
#include "int4_mma.cuh"
#include "mlp_common.cuh"

namespace {

using namespace otter;

constexpr int BH = 128;    // columns (int4_matmul) or hidden units a CTA
constexpr int NT = 256;    // threads per CTA: 8 warps
constexpr int MMAX = 32;   // largest M (decode shapes)

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

// ── int4_matmul: the packed-row product on the tensor cores ──

constexpr int MKC = 64;   // packed rows a stage (128 weight rows)
constexpr int MNS = 6;    // ring slots (MNS - 1 stages in flight)

// Shared memory with NB n-tiles (M <= 8 NB): MNS ring slots, each MKC
// packed rows of the CTA's BH columns (chunks swizzled by `w_chunk`), then
// x's 8 NB rows of the two matching MKC-column slices (the low nibbles'
// columns p, then the high nibbles' K/2 + p; chunks placed by `x_chunk`).
// After the walk the ring holds the upper row half's sums, [8 NB][BH] f32.
template <int NB>
struct MatmulLayout {
  static constexpr int SW = MKC * BH;
  static constexpr int XROW = 2 * MKC * 2;
  static constexpr int STAGE = SW + 8 * NB * XROW;
  static constexpr int BYTES = MNS * STAGE;
  static_assert(8 * NB * BH * 4 <= BYTES, "room for the half sums");
};

// ws[s, m, j0 + c] = x[m, :] @ unpack0(w)[rows_s, j0 + c] for CTA (j, s) of
// a grid (N / BH, splits): rows_s the weight rows of the s-th run of
// K / (2 splits) packed rows [p, p + np), i.e. [p, p + np) and
// [K/2 + p, K/2 + p + np). int4_mlp's phase 1 without the activation: warp
// w takes columns 32 (w % 4) .. + 31 over half w / 4 of every stage's
// packed rows, for all 8 NB rows of x at once; the two halves are added in
// a fixed order through shared memory.
template <int NB>
__global__ void __launch_bounds__(NT, NB == 1 ? 3 : 2) int4_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    float* __restrict__ ws, int M, int K, int N) {
  using L = MatmulLayout<NB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int j0 = blockIdx.x * BH;
  const int k2 = K / 2, np = k2 / gridDim.y, pb = blockIdx.y * np;
  const int nk = np / MKC;

  // stage i's packed rows and x's two slices into ring slot i % MNS (no
  // commit: the caller groups them)
  auto load = [&](int i) {
    if (i >= nk) return;
    unsigned char* st = smem + (i % MNS) * L::STAGE;
    const int p0 = pb + i * MKC;
    for (int e = tid; e < MKC * (BH / 16); e += NT) {
      const int r = e >> 3, c = e & 7;
      cp_async16(st + r * BH + w_chunk(r, c),
                 w + (long long)(p0 + r) * N + j0 + c * 16, true);
    }
    for (int e = tid; e < 8 * NB * (2 * MKC / 8); e += NT) {
      const int m = e >> 4, c = e & 15, hi = c >> 3;
      const bool ok = m < M;
      cp_async16(st + L::SW + m * L::XROW + x_chunk(m, c),
                 ok ? x + (long long)m * K + hi * k2 + p0 + (c & 7) * 8 : x,
                 ok);
    }
  };

  float acc[2][NB][4];
#pragma unroll
  for (int tl = 0; tl < 2; ++tl)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[tl][n][c] = 0.f;

  for (int s = 0; s < MNS - 1; ++s) {
    load(s);
    cp_async_commit();
  }

  const int cg = warp & 3, kh = warp >> 2;
  const int wcol = w_quad(cg, g, t), r0 = kh * (MKC / 2);
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<MNS - 2>();
    __syncthreads();
    // the slot refilled here was read in the previous iteration
    load(i + MNS - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % MNS) * L::STAGE;
    int4_k_steps_rows<NB, BH, L::XROW, MKC / 32>(
        st, r0, wcol, st + L::SW, r0, MKC + r0, g, t, acc);
  }
  // the sum of the partials may be scheduled now (it waits for this
  // grid's end before it reads)
  pdl_launch_dependents();
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
        *reinterpret_cast<float4*>(red + (8 * n + 2 * t + e) * BH + col) =
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
            *reinterpret_cast<const float4*>(red + m * BH + col);
        *reinterpret_cast<float4*>(out + (long long)m * N) = make_float4(
            acc[0][n][e] + hi.x, acc[0][n][2 + e] + hi.y,
            acc[1][n][e] + hi.z, acc[1][n][2 + e] + hi.w);
      }
  }
}

template <int NB>
int launch_matmul_nb(const void* x, const void* w, void* ws, int M, int K,
                     int N, int splits, cudaStream_t st) {
  constexpr int smem = MatmulLayout<NB>::BYTES;
  auto kernel = int4_matmul_kernel<NB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return launch_kernel(false, kernel, dim3(N / BH, splits), NT, smem, st,
                       (const __nv_bfloat16*)x, (const int8_t*)w, (float*)ws,
                       M, K, N);
}

// ceil(M / 8) n-tiles: the weights stream once for any M <= MMAX
int launch_matmul(const void* x, const void* w, void* ws, int M, int K,
                  int N, int splits, cudaStream_t st) {
  switch ((M + 7) / 8) {
    case 1: return launch_matmul_nb<1>(x, w, ws, M, K, N, splits, st);
    case 2: return launch_matmul_nb<2>(x, w, ws, M, K, N, splits, st);
    case 3: return launch_matmul_nb<3>(x, w, ws, M, K, N, splits, st);
    default: return launch_matmul_nb<4>(x, w, ws, M, K, N, splits, st);
  }
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
      (K / 2) % (MKC * splits) != 0 || K % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_matmul(x, w, ws, M, K, N, splits, st);
  if (err != 0) return err;
  return launch_sum_partials_grouped(ws, scale, out, M, N, splits, st,
                                     /*pdl=*/true);
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
