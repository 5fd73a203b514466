// Single-query cached attention for Hopper (sm_90a), read straight from the
// stacked KV cache [B, n_layers, H, L, D]: bf16; int8 with f32 per-position
// scales [B, n_layers, H, L]; or int4, one fused int8 array with k in the
// low nibble of each byte and v in the high, and the same scales.
// q [B, H, D] bf16 -> out [B, H, D] bf16.
//
// Replaces the Pallas TPU kernel otter_tpu/ops/decode_attention.py
// (decode_attention, kernel body in _call), all three cache types. Same
// function, in the same order of operations:
//   s = q.k (f32), quantized: s *= k_scale, then s *= sm_scale, then
//   s += bias; positions outside [starts[b], lengths[b]) take no part;
//   natural-exp online softmax with f32 statistics; quantized: p *= v_scale
//   before p.v, with p rounded to bf16 (the compute dtype) for the product;
//   out = acc / l (l == 0 -> 1).
//
// What bounds it on the H100: it reads each valid cache row once (k and v,
// 2, 1 or 0.5 bytes an element) for 2 multiply-adds per element, so it is
// bound by bytes. The design reads only the valid span [starts, lengths) of
// each (batch, head), addresses the layer inside the stacked cache by its
// stride (no per-layer copy), and dequantizes int8 and int4 rows in
// registers. The int4 cache comes in through one pointer; a byte is loaded
// once for its k nibble (by the lane that owns the key) and once for its v
// nibble (by the lane that owns the column), the second time out of L1:
// device memory gives each byte once.
//
// Design: one CTA of 4 warps per (head, batch); the warps take 32-key
// chunks in turn. For q.k each lane owns one key and walks its row with
// 16-byte loads against q held in shared memory; max and sum reduce over
// the warp. For p.v each lane owns D/32 head-dim columns and walks the
// chunk's 32 value rows (coalesced). The four warps' (m, l, acc) merge in
// shared memory at the end. The TPU's 8-sublane query replication, block_h
// head batching, VMEM budgets and full-cache lax.cond dispatch have no
// counterpart here; split-K over long caches is left for later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int NW = 4;  // warps per CTA

// The three cache types: the element type in memory, one 16-byte load of a
// key row -> N floats (load_k), and one element of a value row -> float
// (v_to_f).
struct CacheBf16 {
  using T = __nv_bfloat16;
  static constexpr int N = 8;
  __device__ static float v_to_f(T x) { return __bfloat162float(x); }
  __device__ static void load_k(const T* p, float* o) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
struct CacheInt8 {
  using T = int8_t;
  static constexpr int N = 16;
  __device__ static float v_to_f(T x) { return (float)x; }
  __device__ static void load_k(const T* p, float* o) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = (float)c[i];
  }
};
// k4 | v4 << 4 in one byte, both nibbles two's complement
struct CacheInt4 {
  using T = int8_t;
  static constexpr int N = 16;
  __device__ static float v_to_f(T x) { return (float)(x >> 4); }
  __device__ static void load_k(const T* p, float* o) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = (float)(((c[i] & 0xF) ^ 8) - 8);
  }
};

template <int D, typename Cache>
__global__ void __launch_bounds__(NW * 32) decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const typename Cache::T* __restrict__ k,
    const typename Cache::T* __restrict__ v,
    const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const float* __restrict__ bias,
    long long bias_sb, long long bias_sh, const int* __restrict__ lengths,
    const int* __restrict__ starts, __nv_bfloat16* __restrict__ out, int H,
    int NL, int layer, int L, float sm_scale) {
  constexpr int DPL = D / 32;  // head-dim columns per lane in p.v
  using KV = typename Cache::T;
  constexpr int VN = Cache::N;
  __shared__ float qs[D];
  __shared__ float red_m[NW], red_l[NW];
  __shared__ float red_acc[NW][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < D; d += NW * 32)
    qs[d] = __bfloat162float(q[((long long)b * H + h) * D + d]);
  __syncthreads();

  const long long row = ((long long)b * NL + layer) * H + h;
  const KV* kp = k + row * L * D;
  const KV* vp = v + row * L * D;
  const float* ksp = k_scale != nullptr ? k_scale + row * L : nullptr;
  const float* vsp = v_scale != nullptr ? v_scale + row * L : nullptr;
  const float* bp = bias != nullptr ? bias + b * bias_sb + h * bias_sh
                                    : nullptr;
  const int start = max(starts[b], 0);
  const int length = min(lengths[b], L);

  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int base = (start & ~31) + warp * 32; base < length;
       base += NW * 32) {
    const int pos = base + lane;
    const bool valid = pos >= start && pos < length;
    float s = -INFINITY;
    if (valid) {
      const KV* kr = kp + (long long)pos * D;
      float dot = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VN) {
        float kv[VN];
        Cache::load_k(kr + d0, kv);
#pragma unroll
        for (int e = 0; e < VN; ++e) dot = fmaf(qs[d0 + e], kv[e], dot);
      }
      if (ksp != nullptr) dot *= ksp[pos];
      dot *= sm_scale;
      if (bp != nullptr) dot += bp[pos];
      s = dot;
    }
    float cmax = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    // empty only when starts[b] >= lengths[b] (warp-uniform)
    if (cmax == -INFINITY) continue;
    const float m_new = fmaxf(m, cmax);
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
    float pq = p;
    if (vsp != nullptr && valid) pq *= vsp[pos];
    pq = __bfloat162float(__float2bfloat16(pq));

    const int jmax = min(32, length - base);
    for (int j = 0; j < jmax; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pq, j);
      if (base + j < start) continue;  // warp-uniform
      const KV* vr = vp + (long long)(base + j) * D + lane * DPL;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[i] = fmaf(pj, Cache::v_to_f(vr[i]), acc[i]);
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
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red_m[w]);
    float lsum = 0.f, o[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (red_m[w] == -INFINITY) continue;
      const float sc = expf(red_m[w] - mx);
      lsum += red_l[w] * sc;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        o[i] = fmaf(red_acc[w][lane * DPL + i], sc, o[i]);
    }
    const float linv = lsum == 0.f ? 1.f : 1.f / lsum;
    __nv_bfloat16* op = out + ((long long)b * H + h) * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) op[i] = __float2bfloat16(o[i] * linv);
  }
}

template <int D, typename Cache>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* bias, long long bsb, long long bsh,
           const void* lengths, const void* starts, void* out, int B, int H,
           int NL, int layer, int L, float sm_scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  using KV = typename Cache::T;
  decode_attention_kernel<D, Cache><<<grid, NW * 32, 0, stream>>>(
      (const __nv_bfloat16*)q, (const KV*)k, (const KV*)v, (const float*)ks,
      (const float*)vs, (const float*)bias, bsb, bsh, (const int*)lengths,
      (const int*)starts, (__nv_bfloat16*)out, H, NL, layer, L, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, int kv_kind, const void* bias, long long bias_sb,
    long long bias_sh, const void* lengths, const void* starts, void* out,
    int B, int H, int NL, int layer, int L, int D, float sm_scale,
    void* stream) {
  // kv_kind: 0 bf16, 1 int8 with scales, 2 fused int4 with scales (read
  // through k alone)
  cudaStream_t st = (cudaStream_t)stream;
  if (kv_kind == 2) v = k;
#define OTTER_LAUNCH(DD, CACHE)                                            \
  return launch<DD, CACHE>(q, k, v, k_scale, v_scale, bias, bias_sb,      \
                           bias_sh, lengths, starts, out, B, H, NL, layer, \
                           L, sm_scale, st)
  if (D == 128) {
    if (kv_kind == 2) OTTER_LAUNCH(128, CacheInt4);
    if (kv_kind == 1) OTTER_LAUNCH(128, CacheInt8);
    if (kv_kind == 0) OTTER_LAUNCH(128, CacheBf16);
  }
  if (D == 64) {
    if (kv_kind == 2) OTTER_LAUNCH(64, CacheInt4);
    if (kv_kind == 1) OTTER_LAUNCH(64, CacheInt8);
    if (kv_kind == 0) OTTER_LAUNCH(64, CacheBf16);
  }
#undef OTTER_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
