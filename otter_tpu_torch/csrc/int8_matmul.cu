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
// weight is converted after the load (exact in bf16), products are
// accumulated in f32 over all of K, multiplied by the scale in f32 and
// rounded once to bf16. Its tiling is not carried over: the TPU kernel walks
// a (N / block_out, K / block_in) grid in order with an accumulator in VMEM,
// pads M to 8 sublanes and needs a block_out that divides N (at N = 32002
// that search ends at 2 columns a block). Here one CTA owns 128 columns,
// runs the whole K loop itself and writes its columns once: no workspace, no
// second launch, no atomics, one fixed order of summation, so a result is
// the same from run to run and a row's result does not depend on M.
//
// What bounds it on the H100: it reads K * N int8 weights once (131 MB and
// 1.07 GB) for 2 M operations a weight with M <= 32, far below the ~295
// operations a byte where the tensor cores would be the limit: bound by
// bytes. But the byte bound leaves an SM little time a byte (its share of
// the memory's rate is ~14.5 bytes a cycle), so what must stay low is the
// instructions a weight byte (f32 FMAs on the CUDA cores cost ~13 a weight at M = 8 and
// grow with M), and what must stay high is the bytes in flight.
//
// Design:
// - mma.sync m16n8k16 in bf16 on the tensor cores with int8_mma.cuh's
//   building blocks: a 16-column weight tile as the A operand, converted in
//   registers by byte permutes (no I2F), and x's rows as 1 to 4 B n-tiles
//   inside the tile loop, so every weight is read once for any M <= 32 at
//   ~3 instructions a weight whatever M is.
// - 8 warps a CTA: warp w takes columns 32 (w % 4) .. + 31 over rows
//   64 (w / 4) .. + 63 of every 128-row stage (18.5 KB with the rows'
//   ninth vectors); the two row halves are added in a fixed order through
//   shared memory at the end, scaled, rounded and stored as bf16.
// - A cp.async ring of four slots, three stages (~55 KB) in flight a CTA
//   and two CTAs an SM: 251 CTAs for LLaMA's head are one wave, Fuyu's 2048
//   run as CTAs free their slots. Wider blocks (256 columns), shorter
//   stages (64 rows), a fifth slot and three CTAs an SM of three slots were
//   all slower on the H100.
// - No address arithmetic in the stage loop beyond a pointer a stage: the
//   vectors a thread fetches and the words it reads are the same in every
//   stage (a row's shift repeats every 16 rows), so their offsets are
//   computed once; only the first and the last stage check the weight's
//   ends and K. That cut 17% at N=262144 and 7% at N=32002.
//
// Rows that are not 16-byte aligned. With N = ldw = 32002 only every 8th
// weight row starts on a 16-byte boundary, and a 128-column block of a row
// in general never does, so 16-byte loads cannot start at the block's first
// column. Each row's block is fetched as it lies, from the 16-byte boundary
// at or below its first byte: nine 16-byte cp.async vectors cover the 128
// wanted bytes at any shift and land in a 144-byte row of shared memory.
// The fragment readers add the row's shift (address & 15, from the row's
// index) and take their four bytes out of two 32-bit words with a funnel
// shift, reading the second word only where the shift is not a multiple of
// 4; the rows are not realigned in memory or in shared memory. An aligned
// weight (N % 16 == 0, Fuyu's) has shift 0 everywhere and its ninth vector
// is never fetched. A vector that would reach before the weight's first
// byte or past its last is filled byte by byte with guards instead (only
// the first and the last row can meet that). Vectors wholly past the
// block's last wanted column, and rows past K in a last half stage, are not
// fetched: whatever their slot holds feeds only columns that are never
// written or meets x's zero-filled columns (an int8 is always finite, so
// the product is 0). Columns past N in the last block are computed on
// whatever the vectors brought (bytes of the next row). Rows of a
// stage lie 144 bytes apart with 32 more every 8 rows, so that the four
// rows one thread reads (4t .. 4t + 3 of a 16-row k step, for t = 0 .. 3
// across a quad) fall in different banks.
#include "int8_mma.cuh"
#include "mlp_common.cuh"

using namespace otter;

namespace {

constexpr int QB = 128;          // output columns per CTA
constexpr int QNT = 256;         // threads per CTA: 8 warps, 2 a column group
constexpr int QKC = 128;         // weight rows per pipeline stage
constexpr int QNS = 4;           // ring slots (QNS - 1 stages in flight)
constexpr int QMAX = 32;         // largest M
constexpr int QWV = QB / 16 + 1; // 16-byte vectors fetched for a row: 9
constexpr int QKS = QKC / 2 / 16;    // k steps a warp takes of a stage
constexpr int QLV = (QKC * QWV + QNT - 1) / QNT;  // vectors a thread fetches

// byte offset of weight row r in a stage
__device__ __forceinline__ int w_row(int r) {
  return r * (16 * QWV) + 32 * (r >> 3);
}

// Shared memory with NB n-tiles (M <= 8 NB): QNS ring slots, each 128
// weight rows of the CTA's 128 columns as fetched, then the matching 128
// columns of x's 8 NB rows (bf16, chunks placed by `x_chunk`). After the
// walk the ring holds the upper row half's sums, [8 NB][QB] f32.
template <int NB>
struct HeadLayout {
  static constexpr int SW = QKC * 16 * QWV + 32 * (QKC / 8);
  static constexpr int XROW = QKC * 2;
  static constexpr int STAGE = SW + 8 * NB * XROW;
  static constexpr int BYTES = QNS * STAGE;
  static_assert(8 * NB * QB * 4 <= BYTES, "room for the half sums");
};

// One warp's QKS k steps over 16 QKS rows of a stage from `wt` (the
// first of them; rows 16 ks + 4 t + i): A from the fetched rows, thread
// (g, t) reading its four columns of row 4 t + i of each 16-row step at
// byte `lo[i]` + 8 sh[i] bits (the row's shift and the column, the same in
// every step: a row's shift repeats every 16 rows), B from `xt` (columns
// from b0) as int8_mma.cuh's `k_steps` reads it.
template <int NB>
__device__ __forceinline__ void head_k_steps(const unsigned char* wt,
                                             const unsigned char* xt, int b0,
                                             const int (&lo)[4],
                                             const int (&sh)[4], int g, int t,
                                             float (&acc)[2][NB][4]) {
#pragma unroll
  for (int ks = 0; ks < QKS; ++ks) {
    const unsigned char* rows = wt + w_row(16 * ks);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(rows + lo[i]);
      w[i] = sh[i] ? __funnelshift_r(p[0], p[1], 8 * sh[i]) : p[0];
    }
    uint32_t a[2][4];
    a_frags(w, a);
    const int bc = ((((b0 + 16 * ks) >> 3) + (t >> 1)) ^ g) << 4;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const uint2 b = *reinterpret_cast<const uint2*>(
          xt + (8 * n + g) * HeadLayout<NB>::XROW + bc + 8 * (t & 1));
      mma_bf16(acc[0][n], a[0], b);
      mma_bf16(acc[1][n], a[1], b);
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(QNT, 2) int8_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
    int K, int N, long long ldw) {
  using L = HeadLayout<NB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int j0 = blockIdx.x * QB;
  const int nc = min(QB, N - j0);           // wanted columns of this block
  const int8_t* wj = w + j0;                // the block's byte of row 0
  const int8_t* w_end = w + (long long)(K - 1) * ldw + N;
  const int nk = (K + QKC - 1) / QKC;
  // the shift of stage row r is (a0 + r * l15) & 15 in every stage
  const int a0 = (int)(reinterpret_cast<uintptr_t>(wj) & 15);
  const int l15 = (int)(ldw & 15);

  // The vectors this thread fetches in every stage: vector v of stage row
  // r, goff[j] bytes from the stage's first row at the block's first
  // column, into byte dst[j] of the slot; dst[j] < 0: none (a vector wholly
  // past the wanted columns: what would land there feeds no written
  // column, as do the rows past K of a last half stage, which are skipped).
  long long goff[QLV];
  int dst[QLV];
#pragma unroll
  for (int j = 0; j < QLV; ++j) {
    const int e = tid + j * QNT, r = e / QWV, v = e - r * QWV;
    const int s = (a0 + r * l15) & 15;
    goff[j] = r * ldw + 16 * v - s;
    dst[j] = e < QKC * QWV && 16 * v - s < nc ? w_row(r) + 16 * v : -1;
  }

  // stage i's weight rows and x columns into ring slot i % QNS (no commit:
  // the caller groups them); only the first and the last stage can reach
  // before the weight's first byte, past its last or past K
  auto load = [&](int i) {
    if (i >= nk) return;
    unsigned char* st = smem + (i % QNS) * L::STAGE;
    const int k0 = i * QKC;
    const int8_t* sb = wj + k0 * ldw;
    const bool edge = i == 0 || i == nk - 1;
#pragma unroll
    for (int j = 0; j < QLV; ++j) {
      if (dst[j] < 0) continue;
      const int8_t* src = sb + goff[j];
      if (!edge) {
        cp_async16(st + dst[j], src, true);
      } else if (k0 + (tid + j * QNT) / QWV >= K) {
        continue;
      } else if (src >= w && src + 16 <= w_end) {
        cp_async16(st + dst[j], src, true);
      } else {
        for (int b = 0; b < 16; ++b) {
          const int8_t* p = src + b;
          st[dst[j] + b] = (p >= w && p < w_end) ? *p : (int8_t)0;
        }
      }
    }
    unsigned char* xs = st + L::SW;
    for (int e = tid; e < 8 * NB * (QKC / 8); e += QNT) {
      const int m = e >> 4, c = e & 15;
      const bool ok = m < M && k0 + c * 8 < K;
      cp_async16(xs + m * L::XROW + x_chunk(m, c),
                 ok ? x + (long long)m * K + k0 + c * 8 : x, ok);
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
  for (int s = 0; s < QNS - 1; ++s) load(s);
  cp_async_commit();   // one group: the first QNS - 1 stages

  // warp (cg, kh) takes columns 32 cg .. + 31 over stage rows r0 ..
  // r0 + 16 QKS - 1; thread (g, t) reads columns col .. col + 3 of row
  // 4 t + i of every 16-row step at byte lo[i] + sh[i] of that row
  const int cg = warp & 3, kh = warp >> 2;
  const int col = 32 * cg + 4 * g, r0 = kh * 16 * QKS;
  int lo[4], sh[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int off = w_row(4 * t + i) + ((a0 + (4 * t + i) * l15) & 15) + col;
    lo[i] = off & ~3;
    sh[i] = off & 3;
  }
  for (int i = 0; i < nk; ++i) {
    if (i == 0) cp_async_wait<0>();
    else cp_async_wait<QNS - 2>();
    __syncthreads();
    // the slot refilled here was read in the previous iteration
    load(i + QNS - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % QNS) * L::STAGE;
    head_k_steps<NB>(st + w_row(r0), st + L::SW, r0, lo, sh, g, t, acc);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is read: it takes the half sums

  // column col + q of row 8 n + 2 t + e: acc[q / 2][n][2 (q % 2) + e]
  float* red = reinterpret_cast<float*>(smem);
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(red + (8 * n + 2 * t + e) * QB + col) =
            make_float4(acc[0][n][e], acc[0][n][2 + e], acc[1][n][e],
                        acc[1][n][2 + e]);
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * n + 2 * t + e;
        if (m >= M) continue;
        const float4 hi =
            *reinterpret_cast<const float4*>(red + m * QB + col);
        const float v[4] = {acc[0][n][e] + hi.x, acc[0][n][2 + e] + hi.y,
                            acc[1][n][e] + hi.z, acc[1][n][2 + e] + hi.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < nc)
            out[(long long)m * N + j0 + col + q] =
                __float2bfloat16(v[q] * scale[j0 + col + q]);
      }
  }
}

template <int NB>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int K, int N, long long ldw, cudaStream_t st) {
  constexpr int smem = HeadLayout<NB>::BYTES;
  auto kernel = int8_matmul_kernel<NB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return launch_kernel(false, kernel, dim3((N + QB - 1) / QB), QNT, smem, st,
                       (const __nv_bfloat16*)x, (const int8_t*)w,
                       (const float*)scale, (__nv_bfloat16*)out, M, K, N,
                       ldw);
}

}  // namespace

// ceil(M / 8) n-tiles: the weight streams once for any M <= QMAX
extern "C" int int8_matmul_bf16(const void* x, const void* w,
                                const void* scale, void* out, int M, int K,
                                int N, long long ldw, void* stream) {
  if (M < 1 || M > QMAX || K < 64 || K % 64 != 0 || N < 1 || ldw < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((M + 7) / 8) {
    case 1: return launch<1>(x, w, scale, out, M, K, N, ldw, st);
    case 2: return launch<2>(x, w, scale, out, M, K, N, ldw, st);
    case 3: return launch<3>(x, w, scale, out, M, K, N, ldw, st);
    default: return launch<4>(x, w, scale, out, M, K, N, ldw, st);
  }
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
