// The tensor-core building blocks of the packed-int4 MLP (int4_mlp.cu):
// nibbles into the A fragments of mma.sync m16n8k16 (bf16 in, f32
// accumulators), with the layout, swizzles and B fragments of
// int8_mma.cuh.
//
// - A thread reads the same four 32-bit words as int8_mma.cuh's `k_steps`:
//   packed rows 4t .. 4t+3 of a 16-row k step at one 4-byte quad. One byte
//   permute a pair of rows puts a quad column's bytes from rows 4t and
//   4t+1 (or 4t+2 and 4t+3) into bytes 0 and 2 of a register, the next
//   column's into bytes 1 and 3; the low nibble of bytes 0 and 2 is then
//   the bf16 pair a fragment register holds (k slots 2t, 2t+1 | 2t+8,
//   2t+9 = rows 4t, 4t+1 | 4t+2, 4t+3, the permuted contracted index of
//   int8_mma.cuh). The next column, and the high nibbles, are the same
//   register shifted by 8, 4 and 12 bits.
// - A nibble n (two's complement, [-8, 7]) to bf16 without I2F: one
//   `lop3`, (v & 0x000F000F) ^ 0x43084308, gives the bf16 pair
//   128 + (n ^ 8) (0x4300 is 128, where a bf16 step is 1), and one bf16x2
//   subtraction of 136 gives n, exactly.
// - So one load of four words gives four m16 tiles' A fragments: the low
//   and the high nibbles of two tiles of quad columns. Packed along the
//   contracted dim (pack_axis 0), the two nibbles are two k steps of the
//   same tiles (contracted rows p and K/2 + p); packed along the output dim
//   (pack_axis 1), they are output columns o and N/2 + o of the same k
//   step.
#pragma once
#include "int8_mma.cuh"

namespace otter {

// the low nibbles of bytes 0 and 2 of v as two exact bf16 values
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  const uint32_t biased = (v & 0x000F000Fu) ^ 0x43084308u;  // 128 + (n ^ 8)
  uint32_t r;
  // biased * 1 - 136 (0x3F80: 1.0, 0xC308: -136)
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// w[i]: 4 packed bytes (columns) of contracted row 4t + i of a k step ->
// a[nib][tl]: the A fragment of nibble `nib` (0 low, 1 high) for tile tl,
// whose rows g and g + 8 are quad columns 2 tl and 2 tl + 1.
__device__ __forceinline__ void int4_frags(const uint32_t (&w)[4],
                                           uint32_t (&a)[2][2][4]) {
#pragma unroll
  for (int tl = 0; tl < 2; ++tl) {
    const uint32_t sel = tl ? 0x7632u : 0x5410u;
    const uint32_t p = __byte_perm(w[0], w[1], sel);   // rows 4t, 4t+1
    const uint32_t q = __byte_perm(w[2], w[3], sel);   // rows 4t+2, 4t+3
#pragma unroll
    for (int nib = 0; nib < 2; ++nib) {
      a[nib][tl][0] = nibbles_bf16x2(p >> (4 * nib));
      a[nib][tl][1] = nibbles_bf16x2(p >> (8 + 4 * nib));
      a[nib][tl][2] = nibbles_bf16x2(q >> (4 * nib));
      a[nib][tl][3] = nibbles_bf16x2(q >> (8 + 4 * nib));
    }
  }
}

// the four words of thread (g, t) at rows r .. r + 3 of a weight tile
// (row stride RS bytes, `wcol`: the thread's `w_quad`)
template <int RS>
__device__ __forceinline__ void quad_words(const unsigned char* wt, int r,
                                           int wcol, uint32_t (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = *reinterpret_cast<const uint32_t*>(wt + (r + i) * RS + wcol);
}

// B fragment of thread (g, t) for n-tile n: activation row 8 n + g of `bt`
// (row stride BS bytes, chunks placed by `x_chunk`), contracted columns
// b0 + 4 t .. + 3 (b0 a multiple of 16)
template <int BS>
__device__ __forceinline__ uint2 b_frag(const unsigned char* bt, int b0,
                                        int n, int g, int t) {
  return *reinterpret_cast<const uint2*>(
      bt + (8 * n + g) * BS + ((((b0 >> 3) + (t >> 1)) ^ g) << 4) +
      8 * (t & 1));
}

// pack_axis 0: KS k steps over packed rows r0 .. r0 + 16 KS - 1 of the
// tile `wt`; the low nibbles meet the B columns from b_lo, the high ones
// those from b_hi (the same rows' x columns p and K/2 + p), both into the
// accumulators of the same two tiles.
template <int NB, int RS, int BS, int KS>
__device__ __forceinline__ void int4_k_steps_rows(
    const unsigned char* wt, int r0, int wcol, const unsigned char* bt,
    int b_lo, int b_hi, int g, int t, float (&acc)[2][NB][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t w[4], a[2][2][4];
    quad_words<RS>(wt, r0 + 16 * ks + 4 * t, wcol, w);
    int4_frags(w, a);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const uint2 lo = b_frag<BS>(bt, b_lo + 16 * ks, n, g, t);
      const uint2 hi = b_frag<BS>(bt, b_hi + 16 * ks, n, g, t);
      mma_bf16(acc[0][n], a[0][0], lo);
      mma_bf16(acc[1][n], a[0][1], lo);
      mma_bf16(acc[0][n], a[1][0], hi);
      mma_bf16(acc[1][n], a[1][1], hi);
    }
  }
}

// pack_axis 1: KS k steps over rows 0 .. 16 KS - 1 of the tile `wt`
// against B columns 0 .. 16 KS - 1; acc[nib][tl] are the low nibbles'
// (output columns o) and the high nibbles' (N/2 + o) tiles.
template <int NB, int RS, int BS, int KS>
__device__ __forceinline__ void int4_k_steps_cols(
    const unsigned char* wt, int wcol, const unsigned char* bt, int g, int t,
    float (&acc)[2][2][NB][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t w[4], a[2][2][4];
    quad_words<RS>(wt, 16 * ks + 4 * t, wcol, w);
    int4_frags(w, a);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const uint2 b = b_frag<BS>(bt, 16 * ks, n, g, t);
#pragma unroll
      for (int nib = 0; nib < 2; ++nib)
#pragma unroll
        for (int tl = 0; tl < 2; ++tl) mma_bf16(acc[nib][tl][n], a[nib][tl], b);
    }
  }
}

}  // namespace otter
