// The attention half of an MPT decode layer in one call, for Hopper
// (sm_90a):
//   n      = bf16(LayerNorm(x) * ln1)                  (f32 statistics)
//   qkv    = (n @ Wqkv) * s_qkv                        (int8 weights, f32 out)
//   attn_h = softmax(q_h . [K_h[:pos] | k_new_h] * sm + alibi) . [V_h | v_new_h]
//   y      = bf16(x + bf16((attn @ Wo) * s_o))
// x [B, D] bf16 (B <= 8); wqo [D, 4D] int8, columns Wqkv | Wo, with f32
// scales sqo [4D]; the stacked cache [B, n_layers, H, L, Dh] bf16 is read
// only, rows [0, pos) of `layer`; bias [H, L] f32 (ALiBi column bias,
// optional). Returns y [B, D], k_new and v_new [B, H, Dh] bf16: the new
// token's k/v never come from the cache, the caller appends them at `pos`.
//
// Replaces the Pallas TPU kernel otter_tpu/ops/megakernel.py:
// decode_attn_megakernel (the kernel body passed to pallas_call there),
// with its rounding points: n, q, k_new, v_new and the attention output are
// rounded to bf16, qkv is f32 after the scale, p is rounded to bf16 for
// p.V (the new token's p is not), the out-projection is rounded to bf16
// before the residual is added in f32.
//
// The TPU kernel walks one sequential grid (qkv column blocks, then
// (batch, head-block) attention steps, then Wo column blocks) and keeps
// n, qkv and attn in VMEM scratch between the steps. Here every phase
// needs all columns of the one before, which many CTAs produce, so the
// phases are five kernels enqueued back to back by one C entry point
// (one call from Python, no host work between them):
//   1. row_norm_kernel: n, one CTA a row (int8_rows.cuh)
//   2. int8_matmul_partial_kernel over Wqkv: split-K partial sums of qkv
//   3. megakernel_attention_kernel: one CTA a (head, batch) adds its
//      3 * Dh columns' partial sums in order, scales them, writes k_new and
//      v_new, and attends: the cache rows as decode_attention.cu does
//      (a lane a key for q.k, a lane Dh/32 columns for p.v, online softmax,
//      four warps merged in shared memory), then the new token out of
//      shared memory
//   4. int8_matmul_partial_kernel over Wo
//   5. sum_partials_kernel with the residual x: y (mlp_common.cuh)
// n, the qkv partial sums and attn cross device memory between the
// kernels (0.5 MB at B = 8, D = 4096): they stay in L2. A cooperative
// launch with grid-wide barriers would save the four kernel boundaries
// (a few microseconds) but ties the grid to one wave of co-resident CTAs;
// left for later. The 8-row pad, the mask-and-sum row extraction, block_w
// / block_h and the repeated block index that elides a DMA on the TPU have
// no counterpart.
//
// What bounds it on the H100: it reads wqo once at 1 byte a weight (67 MB
// at D = 4096) and 2 * B * H * pos * Dh cache elements (33.6 MB at B = 8,
// pos = 256) for 2 B multiply-adds a weight, so it is bound by bytes. Only
// rows below pos are read (the TPU kernel reads all L and masks), the
// layer is addressed inside the stacked cache by its stride (no per-layer
// copy), and the weights are converted in registers.
#include "int8_rows.cuh"

using namespace otter;

namespace {

constexpr int NW = 4;  // warps per attention CTA

template <int DH>
__global__ void __launch_bounds__(NW * 32) megakernel_attention_kernel(
    const float* __restrict__ ws_qkv, int nsplit,
    const float* __restrict__ sqo, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const float* __restrict__ bias,
    long long bias_sh, __nv_bfloat16* __restrict__ k_new,
    __nv_bfloat16* __restrict__ v_new, __nv_bfloat16* __restrict__ attn,
    int B, int H, int NL, int layer, int L, int pos, float sm_scale) {
  constexpr int DPL = DH / 32;  // head-dim columns per lane in p.v
  __shared__ float qs[DH], kn[DH], vn[DH];
  __shared__ float red_m[NW], red_l[NW];
  __shared__ float red_acc[NW][DH];

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = H * DH;

  // this head's q, k_new, v_new: the split-K partial sums in order, scaled
  // (f32), then rounded to bf16 where the attention reads them
  for (int e = threadIdx.x; e < 3 * DH; e += NW * 32) {
    const int part = e / DH, d = e % DH;
    const int col = part * D + h * DH + d;
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s)
      acc += ws_qkv[((long long)s * B + b) * 3 * D + col];
    const __nv_bfloat16 r = __float2bfloat16(acc * sqo[col]);
    const long long o = ((long long)b * H + h) * DH + d;
    if (part == 0) {
      qs[d] = __bfloat162float(r);
    } else if (part == 1) {
      kn[d] = __bfloat162float(r);
      k_new[o] = r;
    } else {
      vn[d] = __bfloat162float(r);
      v_new[o] = r;
    }
  }
  __syncthreads();

  const long long row = ((long long)b * NL + layer) * H + h;
  const __nv_bfloat16* kp = kc + row * L * DH;
  const __nv_bfloat16* vp = vc + row * L * DH;
  const float* bp = bias != nullptr ? bias + h * bias_sh : nullptr;

  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  // cache rows [0, pos): the warps take 32-key chunks in turn
  for (int base = warp * 32; base < pos; base += NW * 32) {
    const int key = base + lane;
    const bool valid = key < pos;
    float s = -INFINITY;
    if (valid) {
      const __nv_bfloat16* kr = kp + (long long)key * DH;
      float dot = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 8) {
        const int4 raw = *reinterpret_cast<const int4*>(kr + d0);
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h2[i]);
          dot = fmaf(qs[d0 + 2 * i], f.x, dot);
          dot = fmaf(qs[d0 + 2 * i + 1], f.y, dot);
        }
      }
      s = dot * sm_scale;
      if (bp != nullptr) s += bp[key];
    }
    float cmax = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    const float m_new = fmaxf(m, cmax);   // lane 0's key is valid: finite
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    const float pq = __bfloat162float(__float2bfloat16(p));

    const int jmax = min(32, pos - base);
    for (int j = 0; j < jmax; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pq, j);
      const __nv_bfloat16* vr = vp + (long long)(base + j) * DH + lane * DPL;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[i] = fmaf(pj, __bfloat162float(vr[i]), acc[i]);
    }
  }

  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) red_acc[warp][lane * DPL + i] = acc[i];
  __syncthreads();
  if (warp == 0) {
    // the new token's logit, from shared memory
    float s_new = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      s_new = fmaf(qs[lane * DPL + i], kn[lane * DPL + i], s_new);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s_new += __shfl_xor_sync(0xffffffffu, s_new, off);
    s_new *= sm_scale;
    if (bp != nullptr) s_new += bp[pos];

    float mx = s_new;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red_m[w]);
    const float p_new = expf(s_new - mx);
    float lsum = p_new, o[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = p_new * vn[lane * DPL + i];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (red_m[w] == -INFINITY) continue;   // a warp that saw no key
      const float sc = expf(red_m[w] - mx);
      lsum += red_l[w] * sc;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        o[i] = fmaf(red_acc[w][lane * DPL + i], sc, o[i]);
    }
    const float linv = 1.f / lsum;
    __nv_bfloat16* op = attn + (long long)b * D + h * DH + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) op[i] = __float2bfloat16(o[i] * linv);
  }
}

template <int DH>
int launch_attention(const void* ws_qkv, int nsplit, const void* sqo,
                     const void* kc, const void* vc, const void* bias,
                     long long bias_sh, void* k_new, void* v_new, void* attn,
                     int B, int H, int NL, int layer, int L, int pos,
                     float sm_scale, cudaStream_t st) {
  megakernel_attention_kernel<DH><<<dim3(H, B), NW * 32, 0, st>>>(
      (const float*)ws_qkv, nsplit, (const float*)sqo,
      (const __nv_bfloat16*)kc, (const __nv_bfloat16*)vc, (const float*)bias,
      bias_sh, (__nv_bfloat16*)k_new, (__nv_bfloat16*)v_new,
      (__nv_bfloat16*)attn, B, H, NL, layer, L, pos, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch, allocated by the caller: normed and attn [B, D] bf16, ws_qkv
// [splits_qkv, B, 3D] f32, ws_o [splits_o, B, D] f32.
extern "C" int decode_attn_megakernel_bf16(
    const void* x, const void* k_cache, const void* v_cache, const void* bias,
    long long bias_sh, const void* ln1, const void* wqo, const void* sqo,
    void* normed, void* ws_qkv, void* attn, void* ws_o, void* y, void* k_new,
    void* v_new, int B, int H, int Dh, int NL, int layer, int L, int pos,
    float eps, float sm_scale, int splits_qkv, int splits_o, void* stream) {
  const int D = H * Dh;
  if (B < 1 || B > 8 || (Dh != 64 && Dh != 128) || pos < 0 || pos >= L ||
      layer < 0 || layer >= NL ||
      !matmul_partial_ok(B, D, 3 * D, 4 * D, splits_qkv) ||
      !matmul_partial_ok(B, D, D, 4 * D, splits_o))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_row_norm(x, nullptr, 0, nullptr, ln1, nullptr, normed, B,
                            D, eps, st);
  if (err != 0) return err;
  err = launch_matmul_partial(normed, wqo, ws_qkv, B, D, 3 * D, 4 * D,
                              splits_qkv, st);
  if (err != 0) return err;
  err = Dh == 128
      ? launch_attention<128>(ws_qkv, splits_qkv, sqo, k_cache, v_cache, bias,
                              bias_sh, k_new, v_new, attn, B, H, NL, layer, L,
                              pos, sm_scale, st)
      : launch_attention<64>(ws_qkv, splits_qkv, sqo, k_cache, v_cache, bias,
                             bias_sh, k_new, v_new, attn, B, H, NL, layer, L,
                             pos, sm_scale, st);
  if (err != 0) return err;
  err = launch_matmul_partial(attn, (const int8_t*)wqo + 3 * D, ws_o, B, D, D,
                              4 * D, splits_o, st);
  if (err != 0) return err;
  return launch_sum_partials(ws_o, (const float*)sqo + 3 * D, nullptr, y, B,
                             D, splits_o, st, x);
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
