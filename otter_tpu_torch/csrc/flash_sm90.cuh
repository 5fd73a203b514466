// Shared pieces of the Hopper (sm_90a) flash-attention kernels in
// flash_fwd.cu and flash_bwd.cu: asynchronous tile loads into bf16 shared
// memory laid out as wgmma's descriptors want (and the key-tile stage and
// the ids-mode test that the forward and dQ walks share), the
// descriptors, the wgmma products, and the helpers that move a
// warpgroup's f32 accumulator in and out of registers.
//
// Tile layout. A tile of R rows x D bf16 columns (row-major in device
// memory) is cut into D / CW column chunks of CW = 64, 32 or 16 elements
// (the widest that divides D: 128-, 64- or 32-byte rows). Each chunk is R
// rows of CW * 2 bytes, one after the other, with the 16-byte units of
// each row XOR-swizzled by the row (Swizzle<B,4,3> for B = 3, 2, 1: bits
// [7, 7 + B) of the byte offset into bits [4, 4 + B)). That is the
// canonical 128B / 64B / 32B swizzled layout of a wgmma operand, and the
// same bytes serve as a K-major operand (rows = M or N, columns = K) and
// as an MN-major one (rows = K, columns = N), so one copy of q, k, v or
// do feeds both kinds of product. Tiles start on 1024-byte boundaries.
//
// Products. `wgmma_ss_n64` multiplies two K-major tiles (A: 64 rows,
// B: 64 rows, K = D in steps of 16). `wgmma_rs_n{16,32,64}` multiplies an
// A held in registers (a 64 x 16 slice of bf16 pairs: the layout of a
// wgmma f32 accumulator, so S or P^T turns into the next product's A
// without leaving registers) by one column chunk of an MN-major tile, so
// an [64 x D] accumulator is D / CW products of N = CW. Accumulator layout
// (thread t of the warpgroup, w = t / 32, g = (t % 32) / 4, tq = t % 4):
// element [n * 4 + 2 * i + j] is row 16 w + g + 8 i, column 8 n + 2 tq + j.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace flash_sm90 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ── layout and descriptors ──────────────────────────────────────────

template <int D>
struct Tile {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head dim");
  static constexpr int CW = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int RB = CW * 2;          // bytes a chunk row
  static constexpr int NCH = D / CW;         // chunks
  static constexpr int SWZ = CW == 64 ? 7 : CW == 32 ? 3 : 1;
  static constexpr uint64_t MODE = CW == 64 ? 1 : CW == 32 ? 2 : 3;
  static constexpr int ATOM = 8 * RB;        // bytes of 8 rows

  // byte offset of element (r, c) in a tile of R rows
  __device__ static __forceinline__ uint32_t offset(int R, int r, int c) {
    const uint32_t o = (c / CW) * R * RB + r * RB + (c % CW) * 2;
    return o ^ (((o >> 7) & SWZ) << 4);
  }
  // the descriptor of the 8-row groups that start at shared address addr;
  // both byte offsets are the 8-row stride (the one along the MN chunks is
  // never used: no product spans two chunks)
  __device__ static __forceinline__ uint64_t desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)(ATOM >> 4) << 16) | ((uint64_t)(ATOM >> 4) << 32) |
           (MODE << 62);
  }
  // K-major operand: rows [r0, r0 + 64) and columns [16 kk, 16 kk + 16)
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int R,
                                                    int r0, int kk) {
    const int c = kk * 16;
    return desc(base + (c / CW) * R * RB + r0 * RB + (c % CW) * 2);
  }
  // MN-major operand: rows (K) [r0, r0 + 16) of column chunk ch
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int R,
                                                     int ch, int r0) {
    return desc(base + ch * R * RB + r0 * RB);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the dynamic shared memory from its first 1024-byte boundary
__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once per
// device (a CUDA API call on every launch costs the small shapes' time)
template <auto kernel>
__host__ inline cudaError_t allow_smem(int bytes) {
  static unsigned done = 0;  // bit d: set on device d (one per kernel)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// ── asynchronous copies ─────────────────────────────────────────────

// 16 bytes global -> shared; zeros when !valid (src is not read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + R) of a contiguous [n, D] bf16 matrix into the tile
// at dst, by NT threads; rows past n read as 0
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int row0, int n, int tid) {
  constexpr int VPR = D / 8;
#pragma unroll  // constant trip count: the addresses fold into offsets
  for (int e = tid; e < R * VPR; e += NT) {
    const int r = e / VPR, c = (e % VPR) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + Tile<D>::offset(R, r, c),
               src + (long long)(ok ? row0 + r : 0) * D + c, ok);
  }
}

// 4-byte elements [i0 + e] of src (e = lane of a group of 64 threads) into
// dst[e]; past n they read as 0
__device__ __forceinline__ void load_row_async(uint32_t dst, const void* src,
                                               int i0, int n, int e) {
  const bool ok = i0 + e < n;
  cp_async4(dst + 4 * e, (const uint32_t*)src + (ok ? i0 + e : 0), ok);
}

// key tile [k0, k0 + 64) of one (batch, head) into a stage by NT threads:
// k and v rows (kb, kb + v_off), and the bias row (if bias) and the kv ids
// (if kid) as 64 f32 / i32 at rows, rows + 256
template <int D, int NT>
__device__ __forceinline__ void load_kv_stage(
    uint32_t kb, uint32_t v_off, uint32_t rows, const __nv_bfloat16* kp,
    const __nv_bfloat16* vp, const float* bias, const int* kid, int k0,
    int Sk, int tid) {
  load_tile_async<D, 64, NT>(kb, kp, k0, Sk, tid);
  load_tile_async<D, 64, NT>(kb + v_off, vp, k0, Sk, tid);
  if (bias != nullptr && tid < 64)
    load_row_async(rows, bias, k0, Sk, tid);
  else if (kid != nullptr && tid >= 64 && tid < 128)
    load_row_async(rows + 64 * 4, kid, k0, Sk, tid - 64);
}

// The ids mode warpgroup wg needs: 0 where its ids mask nothing, else
// mode. "eq" masks nothing when its rows' q ids and every kv id in
// [0, k_end) hold one value, "ge" when the least q id is at least the
// largest kv id (a prompt without padding, one image: most of the
// training and OtterHD batches). row / qid: the thread's two query rows
// and their ids (rows past Sq count for nothing). Every thread of the CTA
// of NT threads calls it (it holds a CTA barrier).
template <int NT>
__device__ __forceinline__ int live_ids_mode(int mode, const int* kid,
                                             int k_end, const int (&row)[2],
                                             const int (&qid)[2], int Sq,
                                             int tid, int wg) {
  __shared__ int red[NT / 32][4];
  int v[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};  // kv min/max, q min/max
  for (int c = tid; c < k_end; c += NT) {
    const int x = kid[c];
    v[0] = min(v[0], x);
    v[1] = max(v[1], x);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (row[i] < Sq) {
      v[2] = min(v[2], qid[i]);
      v[3] = max(v[3], qid[i]);
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = __shfl_xor_sync(0xffffffffu, v[j], off);
      v[j] = (j & 1) ? max(v[j], y) : min(v[j], y);
    }
  if ((tid & 31) == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[tid >> 5][j] = v[j];
  __syncthreads();
#pragma unroll
  for (int wp = 0; wp < NT / 32; ++wp) {
    v[0] = min(v[0], red[wp][0]);
    v[1] = max(v[1], red[wp][1]);
    if (wp >> 2 == wg) {  // q ids: this warpgroup's rows only
      v[2] = min(v[2], red[wp][2]);
      v[3] = max(v[3], red[wp][3]);
    }
  }
  const bool none = mode == 1
                        ? (v[2] == v[3]) & (v[0] == v[1]) & (v[0] == v[2])
                        : v[2] >= v[1];
  return none ? 0 : mode;
}

// ── wgmma ───────────────────────────────────────────────────────────

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread (generic proxy: plain stores and
// cp.async) become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// asynchronous product reads or writes across its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[32] += A (desc_a, K-major) * B (desc_b, K-major): m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[8] += A (registers: bf16 pairs) * B (desc_b, MN-major): m64n16k16
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[16] += A (registers: bf16 pairs) * B (desc_b, MN-major): m64n32k16
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[32] += A (registers: bf16 pairs) * B (desc_b, MN-major): m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// acc[ch] += A * column chunk ch of rows [r0, r0 + 16) of an MN-major tile
template <int D>
__device__ __forceinline__ void wgmma_rs_tile(
    float (&acc)[Tile<D>::NCH][Tile<D>::CW / 2], const uint32_t (&a)[4],
    uint32_t base, int R, int r0) {
#pragma unroll
  for (int ch = 0; ch < Tile<D>::NCH; ++ch) {
    const uint64_t db = Tile<D>::mnmajor(base, R, ch, r0);
    if constexpr (Tile<D>::CW == 64) wgmma_rs_n64(acc[ch], a, db);
    else if constexpr (Tile<D>::CW == 32) wgmma_rs_n32(acc[ch], a, db);
    else wgmma_rs_n16(acc[ch], a, db);
  }
}

// acc[64 x 64] += A (rows [ra0, ra0 + 64) of a K-major tile of RA rows) *
// B^T (rows [rb0, rb0 + 64) of a K-major tile of RB rows), K = D
template <int D>
__device__ __forceinline__ void wgmma_ss_tile(float (&acc)[32], uint32_t a,
                                              int RA, int ra0, uint32_t b,
                                              int RB, int rb0) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(acc, Tile<D>::kmajor(a, RA, ra0, kk),
                 Tile<D>::kmajor(b, RB, rb0, kk));
}

// ── registers ───────────────────────────────────────────────────────

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// a 64 x 64 f32 accumulator as the A operands of four k16 steps, rounded
// to bf16: columns [16 kk, 16 kk + 16) are a[kk]
__device__ __forceinline__ void pack_a(const float (&s)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
}

// 2^x on the special-function unit, denormals flushed to 0 (a p below
// 2^-126 adds nothing next to the row's largest, which is 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a [64 x D] accumulator, row i of the thread's two scaled by scale[i],
// into a plain bf16 tile with row stride D + 8 (conflict-free writes)
template <int D>
__device__ __forceinline__ void stage_acc(
    __nv_bfloat16* st, const float (&acc)[Tile<D>::NCH][Tile<D>::CW / 2],
    const float (&scale)[2], int t) {
  constexpr int CW = Tile<D>::CW;
  const int g = (t & 31) >> 2, tq = t & 3, w = t >> 5;
#pragma unroll
  for (int ch = 0; ch < Tile<D>::NCH; ++ch)
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = w * 16 + g + 8 * i, c = ch * CW + 8 * n + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(st + r * (D + 8) + c) =
            __floats2bfloat162_rn(acc[ch][n * 4 + 2 * i] * scale[i],
                                  acc[ch][n * 4 + 2 * i + 1] * scale[i]);
      }
}

// rows [0, 64) of a staged tile to rows [row0, row0 + 64) of a [n, D]
// matrix in 16-byte stores by 128 threads; rows past n are not written
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* st, int row0,
                                           int n, int t) {
  constexpr int VPR = D / 8;
  for (int e = t; e < 64 * VPR; e += 128) {
    const int r = e / VPR, c = (e % VPR) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(st + r * (D + 8) + c);
  }
}

}  // namespace flash_sm90
