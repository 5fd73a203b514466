// The tensor-core building blocks of the int8 weight-streaming products
// (int8_mlp_kernel.cuh's fused MLP, int8_rows.cuh's split-K product):
// mma.sync m16n8k16 in bf16 with the int8 weight tile as the A operand,
// converted in registers, and the few activation rows as the B operand.
//
// - The weights land in shared memory as they lie in device memory (rows
//   of the contracted dim, 16-byte chunks XOR-swizzled by row: `w_chunk`).
//   A thread reads four 32-bit words, rows 4t .. 4t+3 of a 16-row k step
//   at one 4-column quad (`w_quad`), and permutes them into the A
//   fragments of two m16 tiles (`a_frags`): inside a k step the contracted
//   index is permuted (the mma's k slots 2t, 2t+1, 2t+8, 2t+9 hold rows
//   4t .. 4t+3), and the B fragment is read in that order, one 8-byte load
//   from activation rows whose chunks are swizzled by row (`x_chunk`).
//   A tile's rows g and g + 8 are columns 0 and 1 (or 2 and 3) of quad g:
//   column 4 g + q of a warp's 32 lands in acc[q / 2][n][2 (q % 2) + e]
//   for activation row 8 n + 2 t + e.
// - int8 -> bf16 without I2F: each byte (XOR 0x80) is permuted into the
//   float 2^23 + (b + 128), 2^23 + 128 is subtracted (exact for every
//   int8), and the upper halves of two floats are packed into one bf16x2.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace otter {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// byte `sel` of u (int8 bytes XOR 0x80) as the bits of an exact float
__device__ __forceinline__ uint32_t i8_float(uint32_t u, int sel) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + sel)) -
      8388736.f);
}

// w[i]: 4 int8 columns of contracted row 4t + i of a k step -> the A
// fragments of two m16 tiles: tile 0's rows g, g + 8 are columns 0, 1,
// tile 1's columns 2, 3; k slots (2t, 2t+1 | 2t+8, 2t+9) are rows
// (4t, 4t+1 | 4t+2, 4t+3). bf16 is a float's upper half.
__device__ __forceinline__ void a_frags(const uint32_t (&w)[4],
                                        uint32_t (&a)[2][4]) {
  uint32_t f[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int c = 0; c < 4; ++c) f[i][c] = i8_float(u, c);
  }
#pragma unroll
  for (int tl = 0; tl < 2; ++tl) {
    a[tl][0] = __byte_perm(f[0][2 * tl], f[1][2 * tl], 0x7632u);
    a[tl][1] = __byte_perm(f[0][2 * tl + 1], f[1][2 * tl + 1], 0x7632u);
    a[tl][2] = __byte_perm(f[2][2 * tl], f[3][2 * tl], 0x7632u);
    a[tl][3] = __byte_perm(f[2][2 * tl + 1], f[3][2 * tl + 1], 0x7632u);
  }
}

// Byte offset, inside its row, of 16-byte chunk c of weight row r (rows
// 4t .. 4t+3 of a k step, which one thread reads, fall in distinct banks).
__device__ __forceinline__ int w_chunk(int r, int c) {
  return (c ^ ((r >> 1) & 6)) << 4;
}
// ... of chunk c of activation row m.
__device__ __forceinline__ int x_chunk(int m, int c) {
  return (c ^ (m & 7)) << 4;
}
// The byte offset of thread (g, t)'s quad in a weight row, for the warp
// that takes columns 32 cg .. 32 cg + 31, in any k step's rows (16-row
// aligned, so the row swizzle is 2 t).
__device__ __forceinline__ int w_quad(int cg, int g, int t) {
  return (((2 * cg + (g >> 2)) ^ (2 * t)) << 4) + 4 * (g & 3);
}

// One warp's KS k steps over 16 KS contracted rows: A from the weight tile
// `wt` (row stride RS bytes; `wcol`: the thread's `w_quad`, rows r0 ..
// r0 + 16 KS - 1, r0 a multiple of 16), B from `bt` (8 NB rows of bf16,
// row stride BS bytes, the contracted index starting at column `b0`,
// chunks placed by `x_chunk`).
template <int NB, int RS, int BS, int KS = 8>
__device__ __forceinline__ void k_steps(const unsigned char* wt, int r0,
                                        int wcol, const unsigned char* bt,
                                        int b0, int g, int t,
                                        float (&acc)[2][NB][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int r = r0 + 16 * ks + 4 * t;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const uint32_t*>(wt + (r + i) * RS + wcol);
    uint32_t a[2][4];
    a_frags(w, a);
    const int bc = ((((b0 + 16 * ks) >> 3) + (t >> 1)) ^ g) << 4;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const uint2 b = *reinterpret_cast<const uint2*>(
          bt + (8 * n + g) * BS + bc + 8 * (t & 1));
      mma_bf16(acc[0][n], a[0], b);
      mma_bf16(acc[1][n], a[1], b);
    }
  }
}

}  // namespace otter
