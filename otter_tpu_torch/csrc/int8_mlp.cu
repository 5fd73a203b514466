// Fused int8 weight-only MLP for Hopper (sm_90a):
//   y = (round_x(act((x @ W1q) * s1 + b1)) @ W2q) * s2 + b2
// x [M, K] bf16 (M <= 32), W1q [K, H] int8, s1 [H] f32, W2q [H, N] int8,
// s2 [N] f32, optional biases b1 [H], b2 [N] f32; y [M, N] bf16;
// ws is f32 scratch [H/128, M, N].
//
// Replaces the Pallas TPU kernel otter_tpu/ops/quant.py:int8_mlp (the
// kernel body passed to pallas_call there). The TPU walks the hidden dim H
// in order and carries one f32 accumulator across grid steps; here the H
// blocks run in parallel, one CTA each, and each CTA writes its partial
// output to its own slice of an f32 workspace [H/128, M, N]; a second small
// launch (mlp_common.cuh) sums the slices in a fixed order, applies s2
// (+ b2) and casts to bf16. No atomics: the result is the same from run to
// run, so greedy decoding is reproducible. (f32 atomicAdd would save the workspace, 2 MB
// a row of M, but its order changes between runs and flips near-tied
// argmaxes.) The tolerance against the plain version is a bf16 one: the
// sums run in another order than the plain version's matmul.
//
// What bounds it on the H100: at decode (M = batch <= 8) it reads
// 2 * 4096 * 16384 int8 weights (134 MB) per call for ~2*M*134M
// multiply-adds, so it is bound by bytes. The design reads every weight
// once, as int8 (1 byte/weight), converts it in registers, and keeps the
// hidden activation in shared memory (never in device memory). The
// products run on the CUDA cores in f32 in this first version.
//
// Design: CTA j owns hidden units [128 j, 128 j + 128), 256 threads.
//   Phase 1: W1's 128-column block streams through shared memory in
//   64-row stages, three in flight (cp.async, so the loads of the next
//   stages overlap the multiply-adds of this one), with the matching
//   slice of x; each of the 8 warps sums 8 rows of every stage for 4
//   hidden units a lane, 8 (or 1) rows of x at a time; the warps' partial
//   sums are added in a fixed order, scaled by s1, biased, activated, and
//   rounded to bf16 (x's dtype, as the TPU kernel rounds before its second
//   dot) into shared memory.
//   Phase 2: W2's 128-row block streams through shared memory in 4-row
//   stages of up to 4096 columns, four in flight; each thread owns 16
//   consecutive output columns, accumulates the CTA's 128 hidden units
//   for the row group, and stores the partial sums in its workspace slice.
#include "int8_mlp_kernel.cuh"

using namespace otter;

extern "C" int int8_mlp_bf16(const void* x, const void* w1, const void* s1,
                             const void* b1, const void* w2, const void* s2,
                             const void* b2, void* ws, void* out, int M,
                             int K, int H, int N, int act, void* stream) {
  if (M < 1 || M > MMAX || K % KC != 0 || H % BH != 0 || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = M == 1
      ? launch_hidden<1>(x, w1, s1, b1, w2, ws, M, K, H, N, act, st)
      : launch_hidden<8>(x, w1, s1, b1, w2, ws, M, K, H, N, act, st);
  if (err != 0) return err;
  return launch_sum_partials(ws, s2, b2, out, M, N, H / BH, st);
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
