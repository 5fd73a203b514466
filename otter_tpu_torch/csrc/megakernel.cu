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
// phases are five kernels enqueued by one C entry point (one call from
// Python, no host work between them):
//   1. row_norm_kernel: n, one CTA a row (int8_rows.cuh)
//   2. int8_matmul_partial_kernel over Wqkv: split-K partial sums of qkv
//      on the tensor cores, every weight read once (int8_rows.cuh)
//   3. megakernel_attention_kernel: the span [0, pos) of each (batch,
//      head) cut into chunks, one CTA a chunk (attention_plan in
//      ops/megakernel.py: one wave of the card where B * H allows). A CTA
//      adds its head's 3 * Dh columns of partial sums in order and scales
//      them (q, and k_new / v_new, which chunk 0 writes out), then walks
//      its rows as decode_attention.cu does: a row is read whole by
//      Dh / 8 lanes in 16-byte loads, their dot products added by xor
//      shuffles; each of the four warps brings its 8- or 16-row steps in
//      by a three-step cp.async ring (k, v and the bias); online softmax
//      in f32 with p rounded to bf16 for p.v; the warps merged in warp
//      order. The last CTA of a (batch, head) to finish (an integer
//      counter, reset by that CTA) merges the new token's term and then
//      the chunks' (m, l, acc) in chunk order: no float atomics.
//   4. int8_matmul_partial_kernel over Wo
//   5. sum_partials_kernel with the residual x: y (mlp_common.cuh)
// n, the qkv partial sums, the chunks' partials and attn cross device
// memory between the kernels (~1 MB at B = 8, D = 4096): they stay in L2.
// Kernels 2-5 are programmatic dependent launches: each starts while the
// kernel before it drains, the products streaming their first weight
// stages before they wait for their input (mlp_common.cuh: pdl_wait);
// before its wait a kernel reads only weights, scales and the ALiBi bias
// and writes nothing. The 8-row pad, the mask-and-sum row extraction,
// block_w / block_h and the repeated block index that elides a DMA on the
// TPU have no counterpart.
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

constexpr int NW = 4;          // warps per attention CTA
constexpr int ANS = 3;         // steps in each warp's ring
constexpr int STAGE_K = 2048;  // bytes of k rows a step (v the same)

// The attention CTA's walk over bf16 cache rows, as decode_attention.cu
// walks them: a row is LPR lanes of 16 bytes, a warp load covers RPW rows,
// a step R rows (2 KB of k, 2 KB of v and R bias values).
template <int DH>
struct AttnGeo {
  static constexpr int RB = DH * 2;                 // bytes a row
  static constexpr int LPR = RB / 16;               // lanes a row
  static constexpr int RPW = 32 / LPR;              // rows a warp load
  static constexpr int R = STAGE_K / RB;            // rows a step
  static constexpr int U = R / RPW;                 // loads a lane a step
  static constexpr int STAGE = 2 * STAGE_K + 4 * R;  // k, v, bias
  static constexpr int SMEM = NW * ANS * STAGE;
  static_assert(U * RPW == R && R <= 32, "step shape");
};

struct AttnArgs {
  const float* ws_qkv;        // [nsplit, B, 3D] partial sums of qkv
  const float* sqo;           // [4D] column scales
  const __nv_bfloat16* kc;    // [B, NL, H, L, DH]
  const __nv_bfloat16* vc;
  const float* bias;          // [H, >= L] rows of stride bias_sh, or null
  long long bias_sh;
  __nv_bfloat16* k_new;       // [B, H, DH]
  __nv_bfloat16* v_new;
  __nv_bfloat16* attn;        // [B, D]
  float* part;                // [B, H, n_splits, 2 + DH]: m, l, acc a chunk
  int* counters;              // [B, H], 0 between calls
  int nsplit, B, H, NL, layer, L, pos, n_splits, min_rows;
  float sm_scale;
};

template <int DH>
__global__ void __launch_bounds__(NW * 32) megakernel_attention_kernel(
    AttnArgs a) {
  using G = AttnGeo<DH>;
  constexpr int R = G::R, RB = G::RB, LPR = G::LPR, RPW = G::RPW, U = G::U;
  constexpr int DPL = DH / 32;  // head-dim columns per lane, new token
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float qs[DH], kn[DH], vn[DH], s_new_sh;
  __shared__ float red_m[NW], red_l[NW], red_acc[NW][DH];
  __shared__ int last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.H * DH;
  const long long bh = (long long)b * a.H + h;

  // this CTA's chunk of [0, pos), cut as ops/decode_attention.py:
  // split_chunks cuts it (pos 0: one CTA, no cache row)
  int used = 1, lo = 0, hi = 0;
  if (a.pos > 0) {
    const int n = max(1, min(a.n_splits, a.pos / a.min_rows));
    const int chunk = (a.pos + n - 1) / n;
    used = (a.pos + chunk - 1) / chunk;
    lo = split * chunk;
    hi = min(lo + chunk, a.pos);
  }
  if (split >= used) return;
  pdl_wait();                // qkv's partial sums come from the kernel before
  pdl_launch_dependents();   // the out-projection may stream its weights

  const long long row = ((long long)b * a.NL + a.layer) * a.H + h;
  const uint8_t* kp = reinterpret_cast<const uint8_t*>(a.kc) + row * a.L * RB;
  const uint8_t* vp = reinterpret_cast<const uint8_t*>(a.vc) + row * a.L * RB;
  const float* bp =
      a.bias != nullptr ? a.bias + (long long)h * a.bias_sh : nullptr;
  const int c0 = (lane % LPR) * 8, rl = lane / LPR;
  uint8_t* ring = smem + warp * ANS * G::STAGE;
  const int steps = (hi - lo + R - 1) / R;
  const int n_w = steps > warp ? (steps - warp + NW - 1) / NW : 0;
  const uint32_t col = (lane % LPR) * 16;

  // rows of warp step i into ring slot i % ANS (rows past hi read as 0);
  // always one commit group, empty past the warp's last step
  auto fetch = [&](int i) {
    if (i < n_w) {
      const int base = lo + (warp + NW * i) * R;
      uint8_t* st = ring + (i % ANS) * G::STAGE;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = u * RPW + rl, p = base + rr;
        const bool ok = p < hi;
        const long long off = (long long)(ok ? p : 0) * RB + col;
        cp_async16(st + rr * RB + col, kp + off, ok);
        cp_async16(st + STAGE_K + rr * RB + col, vp + off, ok);
      }
      if (bp != nullptr && lane < R) {
        const int p = base + lane;
        const bool ok = p < hi;
        cp_async4(st + 2 * STAGE_K + 4 * lane, bp + (ok ? p : 0), ok);
      }
    }
    cp_async_commit();
  };
  // the first cache rows are in flight while q, k_new and v_new finish
#pragma unroll
  for (int i = 0; i < ANS - 1; ++i) fetch(i);

  // this head's q, k_new, v_new: the split-K partial sums in order, scaled
  // (f32), then rounded to bf16 where the attention reads them
  for (int e = tid; e < 3 * DH; e += NW * 32) {
    const int part = e / DH, d = e % DH;
    const int c = part * D + h * DH + d;
    float acc = 0.f;
    for (int s = 0; s < a.nsplit; ++s)
      acc += a.ws_qkv[((long long)s * a.B + b) * 3 * D + c];
    const __nv_bfloat16 r = __float2bfloat16(acc * a.sqo[c]);
    const long long o = bh * DH + d;
    if (part == 0) {
      qs[d] = __bfloat162float(r);
    } else if (part == 1) {
      kn[d] = __bfloat162float(r);
      if (split == 0) a.k_new[o] = r;
    } else {
      vn[d] = __bfloat162float(r);
      if (split == 0) a.v_new[o] = r;
    }
  }
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
    s_new *= a.sm_scale;
    if (bp != nullptr) s_new += bp[a.pos];
    if (lane == 0) s_new_sh = s_new;
  }

  // the lane's slice of q: columns [c0, c0 + 8) of every row it reads
  float qf[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qf[j] = qs[c0 + j];

  float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  for (int i = 0; i < n_w; ++i) {
    fetch(i + ANS - 1);  // into the slot step i - 1 left
    cp_async_wait<ANS - 1>();
    __syncwarp();        // the bias came through other lanes
    const uint8_t* st = ring + (i % ANS) * G::STAGE;
    const float* sbias = reinterpret_cast<const float*>(st + 2 * STAGE_K);
    const int base = lo + (warp + NW * i) * R;

    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = u * RPW + rl;
      const uint4 raw = *reinterpret_cast<const uint4*>(st + rr * RB + col);
      const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dot = fmaf(qf[2 * j], __uint_as_float(w4[j] << 16), dot);
        dot = fmaf(qf[2 * j + 1], __uint_as_float(w4[j] & 0xFFFF0000u), dot);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      dot *= a.sm_scale;
      if (bp != nullptr) dot += sbias[rr];
      s[u] = base + rr < hi ? dot : -INFINITY;
    }
    // every step holds a row below hi: m_new is finite
    float mx = s[0];
#pragma unroll
    for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u]);
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = u * RPW + rl;
      const float p = expf(s[u] - m_new);
      l += p;
      const float pq = __bfloat162float(__float2bfloat16(p));
      const uint4 raw =
          *reinterpret_cast<const uint4*>(st + STAGE_K + rr * RB + col);
      const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[2 * j] = fmaf(pq, __uint_as_float(w4[j] << 16), acc[2 * j]);
        acc[2 * j + 1] =
            fmaf(pq, __uint_as_float(w4[j] & 0xFFFF0000u), acc[2 * j + 1]);
      }
    }
    __syncwarp();  // the slot is refilled by the next step's fetch
  }
  cp_async_wait<0>();

  // the row groups' sums (every lane of a row group holds the same l)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  if (lane < LPR)
#pragma unroll
    for (int j = 0; j < 8; ++j) red_acc[warp][c0 + j] = acc[j];
  __syncthreads();

  // the warps' sums in warp order; thread t < DH holds column t
  float mc = red_m[0], lc = 0.f, ac = 0.f;
#pragma unroll
  for (int w = 1; w < NW; ++w) mc = fmaxf(mc, red_m[w]);
  if (tid < DH) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (red_m[w] == -INFINITY) continue;  // a warp without rows
      const float f = expf(red_m[w] - mc);
      lc += red_l[w] * f;
      ac = fmaf(red_acc[w][tid], f, ac);
    }
  }

  // the output: the new token first, then the chunks in chunk order
  const float s_new = s_new_sh;
  __nv_bfloat16* op = a.attn + (long long)b * D + h * DH;
  if (used == 1) {
    if (tid < DH) {
      const float mg = fmaxf(s_new, mc);
      const float p_new = expf(s_new - mg);
      float lg = p_new, ag = p_new * vn[tid];
      if (mc != -INFINITY) {  // the CTA saw a cache row
        const float f = expf(mc - mg);
        lg += lc * f;
        ag = fmaf(ac, f, ag);
      }
      op[tid] = __float2bfloat16(ag * (1.f / lg));
    }
    return;
  }
  float* part = a.part + (bh * a.n_splits + split) * (2 + DH);
  if (tid < DH) part[2 + tid] = ac;
  if (tid == 0) {
    part[0] = mc;
    part[1] = lc;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(a.counters + bh, 1);
    last = done == used - 1;
    if (last) a.counters[bh] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!last || tid >= DH) return;
  __threadfence();
  // every chunk holds a row: each m is finite
  const float* parts = a.part + bh * a.n_splits * (2 + DH);
  float mg = s_new;
  for (int s = 0; s < used; ++s) mg = fmaxf(mg, __ldcg(parts + s * (2 + DH)));
  const float p_new = expf(s_new - mg);
  float lg = p_new, ag = p_new * vn[tid];
  for (int s = 0; s < used; ++s) {
    const float* ps = parts + s * (2 + DH);
    const float f = expf(__ldcg(ps) - mg);
    lg += __ldcg(ps + 1) * f;
    ag = fmaf(__ldcg(ps + 2 + tid), f, ag);
  }
  op[tid] = __float2bfloat16(ag * (1.f / lg));
}

template <int DH>
int launch_attention(const AttnArgs& a, cudaStream_t st) {
  constexpr int smem = AttnGeo<DH>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      megakernel_attention_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return launch_kernel(true, megakernel_attention_kernel<DH>,
                       dim3(a.n_splits, a.H, a.B), NW * 32, smem, st, a);
}

}  // namespace

// Scratch, allocated by the caller: normed and attn [B, D] bf16, ws_qkv
// [splits_qkv, B, 3D] f32, ws_o [splits_o, B, D] f32; for an attention
// phase of attn_splits > 1 CTAs a (batch, head) (ops/megakernel.py:
// attention_plan, with chunks of at least attn_min_rows rows), attn_part
// [B, H, attn_splits, 2 + Dh] f32 and attn_counters [B, H] int32, 0 before
// the call and left so (decode_attention's workspace).
extern "C" int decode_attn_megakernel_bf16(
    const void* x, const void* k_cache, const void* v_cache, const void* bias,
    long long bias_sh, const void* ln1, const void* wqo, const void* sqo,
    void* normed, void* ws_qkv, void* attn, void* ws_o, void* attn_part,
    void* attn_counters, void* y, void* k_new, void* v_new, int B, int H,
    int Dh, int NL, int layer, int L, int pos, float eps, float sm_scale,
    int splits_qkv, int splits_o, int attn_splits, int attn_min_rows,
    void* stream) {
  const int D = H * Dh;
  if (B < 1 || B > 8 || (Dh != 64 && Dh != 128) || pos < 0 || pos >= L ||
      layer < 0 || layer >= NL ||
      !matmul_partial_ok(B, D, 3 * D, 4 * D, splits_qkv) ||
      !matmul_partial_ok(B, D, D, 4 * D, splits_o) || attn_splits < 1 ||
      attn_min_rows < 1 ||
      (attn_splits > 1 && (attn_part == nullptr || attn_counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_row_norm(x, nullptr, 0, nullptr, ln1, nullptr, normed, B,
                            D, eps, st);
  if (err != 0) return err;
  err = launch_matmul_partial(normed, wqo, ws_qkv, B, D, 3 * D, 4 * D,
                              splits_qkv, st, true);
  if (err != 0) return err;
  AttnArgs a;
  a.ws_qkv = (const float*)ws_qkv;
  a.sqo = (const float*)sqo;
  a.kc = (const __nv_bfloat16*)k_cache;
  a.vc = (const __nv_bfloat16*)v_cache;
  a.bias = (const float*)bias;
  a.bias_sh = bias_sh;
  a.k_new = (__nv_bfloat16*)k_new;
  a.v_new = (__nv_bfloat16*)v_new;
  a.attn = (__nv_bfloat16*)attn;
  a.part = (float*)attn_part;
  a.counters = (int*)attn_counters;
  a.nsplit = splits_qkv;
  a.B = B;
  a.H = H;
  a.NL = NL;
  a.layer = layer;
  a.L = L;
  a.pos = pos;
  a.n_splits = attn_splits;
  a.min_rows = attn_min_rows;
  a.sm_scale = sm_scale;
  err = Dh == 128 ? launch_attention<128>(a, st) : launch_attention<64>(a, st);
  if (err != 0) return err;
  err = launch_matmul_partial(attn, (const int8_t*)wqo + 3 * D, ws_o, B, D, D,
                              4 * D, splits_o, st, true);
  if (err != 0) return err;
  return launch_sum_partials(ws_o, (const float*)sqo + 3 * D, nullptr, y, B,
                             D, splits_o, st, x, true);
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
