// The tail of an MPT decode layer in one call, for Hopper (sm_90a):
//   y   = bf16(r + bf16((a @ Wo) * so))                (attention out-proj)
//   n   = bf16(LayerNorm(y) * g)                       (f32 statistics)
//   out = bf16(y + bf16((bf16(act((n @ W1) * s1)) @ W2) * s2))
// a [M, hd] bf16 (M <= 32): the raw attention output; r [M, D] bf16: the
// residual; Wo [hd, D], W1 [D, H], W2 [H, D] int8 with f32 per-column
// scales so [D], s1 [H], s2 [D]; g [D] f32; out [M, D] bf16.
//
// Replaces the Pallas TPU kernel otter_tpu/ops/quant.py:int8_attn_tail (the
// kernel body passed to pallas_call there), with its rounding points: the
// out-projection is rounded to bf16 before the residual is added in f32, y
// is kept in bf16, the norm runs in f32 and is rounded, the hidden
// activation is rounded before the second product, and the MLP's result is
// rounded before it is added to y. GELU is the exact erf form (erff); the
// TPU kernel's polynomial erf stands in for an erf its compiler lacks.
//
// The TPU kernel walks one sequential grid: Wo column blocks, the norm
// "once at the phase boundary", then the MLP's hidden blocks with one
// accumulator carried across the grid steps. Here the norm needs every
// column of y, which many CTAs produce, and the MLP's hidden blocks run in
// parallel, so the phases are four kernels enqueued back to back by one C
// entry point (one call from Python, no host work between them):
//   1. int8_matmul_partial_kernel over Wo: split-K partial sums
//      (int8_rows.cuh)
//   2. row_norm_kernel: y and n, one CTA a row
//   3. int8_mlp_hidden_kernel on n: the fused MLP's main kernel, partial
//      sums of the second product to an f32 workspace (int8_mlp_kernel.cuh)
//   4. sum_partials_kernel with the residual y: out (mlp_common.cuh)
// y, n and the partial sums cross device memory between the kernels (a few
// MB at M = 8): they stay in L2. A cooperative launch with grid-wide
// barriers would save the three kernel boundaries but ties the grid to one
// wave of co-resident CTAs; left for later.
//
// What bounds it on the H100: it reads 9 D^2 int8 weights once (151 MB at
// D = 4096, H = 4 D) for 2 M multiply-adds a weight, so it is bound by
// bytes; every weight is read once at 1 byte and converted in registers.
// The products run on the CUDA cores in f32.
#include "int8_mlp_kernel.cuh"
#include "int8_rows.cuh"

using namespace otter;

// Scratch, allocated by the caller: ws_o [splits, M, D] f32, y and normed
// [M, D] bf16, ws_mlp [H / 128, M, D] f32.
extern "C" int int8_attn_tail_bf16(
    const void* a, const void* r, const void* wo, const void* so,
    const void* g, const void* w1, const void* s1, const void* w2,
    const void* s2, void* ws_o, void* y, void* normed, void* ws_mlp,
    void* out, int M, int HD, int D, int H, float eps, int act, int splits,
    void* stream) {
  if (!matmul_partial_ok(M, HD, D, D, splits) || D % KC != 0 || H % BH != 0 ||
      act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_matmul_partial(a, wo, ws_o, M, HD, D, D, splits, st);
  if (err != 0) return err;
  err = launch_row_norm(r, ws_o, splits, so, g, y, normed, M, D, eps, st);
  if (err != 0) return err;
  err = M == 1
      ? launch_hidden<1>(normed, w1, s1, nullptr, w2, ws_mlp, M, D, H, D, act,
                         st)
      : launch_hidden<8>(normed, w1, s1, nullptr, w2, ws_mlp, M, D, H, D, act,
                         st);
  if (err != 0) return err;
  return launch_sum_partials(ws_mlp, s2, nullptr, out, M, D, H / BH, st, y);
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
