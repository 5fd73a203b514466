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
// Only the order in which the partial sums of the chunks below are added
// differs from one pass over the cache.
//
// What bounds it on the H100: it reads each valid cache row once (k and v,
// 2, 1 or 0.5 bytes an element) for 2 multiply-adds per element, so it is
// bound by bytes. It reads only the valid span [starts, lengths) of each
// (batch, head), addresses the layer inside the stacked cache by its
// stride (no per-layer copy), and dequantizes int8 and int4 rows in
// registers (a byte permute into 2^23 and a subtract an element).
//
// Design. The span of each (batch, head) is split into chunks so that the
// grid fills the card: the host's plan (ops/decode_attention.py:
// split_plan, a pure function of B, H, the cache length, D and the cache
// type) gives the number of splits and the fewest rows a chunk may hold;
// each CTA cuts the real span [starts[b], lengths[b]) the same way
// (split_chunks there) and takes chunk blockIdx.x. A CTA is 4 warps; warp
// w takes steps w, w + 4, ... of R rows (2 KB of k rows a step). A warp
// reads whole rows with 16-byte loads: a row is RB / 16 lanes (D = 128
// int8: 8 lanes, 4 rows a load; D = 64 int8: 4 lanes, 8 rows), so a load
// instruction covers 512 consecutive bytes. The rows arrive by cp.async in
// a ring of three steps a warp (two in flight while one is computed), each
// lane copying the 16 bytes it reads itself; the per-row scales and bias
// come with them. q.k: each lane dots its 16 bytes with its slice of q,
// and the lanes of a row add theirs with xor shuffles. p.v: the same lanes
// multiply the same rows' v bytes by p and keep f32 sums of their columns;
// the row groups' sums are added once, at the end of the walk. The four
// warps' (m, l, acc) merge in shared memory in warp order. A span of one
// chunk writes out directly. Otherwise every CTA writes its (m, l, acc)
// to the workspace, and the last CTA of its (batch, head) to finish (an
// integer counter a (batch, head), reset by that CTA) merges all of them
// in chunk order: no floating-point atomics, so a call gives the same bits
// every time. The TPU's 8-sublane query replication, block_h head
// batching, VMEM budgets and full-cache lax.cond dispatch have no
// counterpart here.
#include "flash_sm90.cuh"

#include <math.h>

namespace {

using flash_sm90::cp_async16;
using flash_sm90::cp_async4;
using flash_sm90::cp_async_commit;
using flash_sm90::cp_async_wait;

constexpr int NW = 4;          // warps a CTA
constexpr int NS = 3;          // steps in each warp's ring
constexpr int STAGE_K = 2048;  // bytes of k rows a step (v the same)

enum Kind { BF16 = 0, INT8 = 1, INT4 = 2 };

template <int D, int KIND>
struct Geo {
  static constexpr int E = KIND == BF16 ? 2 : 1;  // bytes an element
  static constexpr int RB = D * E;                // bytes a row
  static constexpr int LPR = RB / 16;             // lanes a row
  static constexpr int RPW = 32 / LPR;            // rows a warp load
  static constexpr int R = STAGE_K / RB;          // rows a step
  static constexpr int U = R / RPW;               // loads a lane a step
  static constexpr int N = 16 / E;                // elements a lane a row
  static constexpr bool FUSED = KIND == INT4;     // k and v in one byte
  static constexpr int SC = FUSED ? STAGE_K : 2 * STAGE_K;  // ks, vs, bias
  static constexpr int STAGE = SC + 3 * R * 4;
  static constexpr int SMEM = NW * NS * STAGE;
  static_assert(R <= 32 && U * RPW == R, "step shape");
};

struct Args {
  const __nv_bfloat16* q;
  const uint8_t* k;
  const uint8_t* v;
  const float* k_scale;
  const float* v_scale;
  const float* bias;
  long long bias_sb, bias_sh;
  const int* lengths;
  const int* starts;
  __nv_bfloat16* out;
  float* ws;      // [B, H, n_splits, 2 + D]: m, l, acc of each chunk
  int* counters;  // [B, H], 0 between calls
  int H, NL, layer, L, n_splits, min_rows;
  float sm_scale;
};

// float(b) of the signed byte `sel` of u, where u holds bytes b ^ 0x80:
// 0x4B0000uu is 2^23 + uu as a float, and uu = b + 128
__device__ __forceinline__ float byte_to_float(uint32_t u, uint32_t sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + sel)) -
         8388736.f;
}
// nibble i of a byte-wise word whose nibbles hold n ^ 8: n, sign-extended
__device__ __forceinline__ float nib_to_float(uint32_t u, uint32_t sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + sel)) -
         8388616.f;
}

// the N elements of one lane's 16 bytes of a k row (kv = false) or of a v
// row (kv = true) as floats
template <int KIND, bool kV>
__device__ __forceinline__ void unpack(const uint4& raw, float* o) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (KIND == BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else if constexpr (KIND == INT8) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[4 * i + j] = byte_to_float(w[i] ^ 0x80808080u, j);
  } else {  // k in the low nibble of each byte, v in the high
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t n =
          ((kV ? w[i] >> 4 : w[i]) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[4 * i + j] = nib_to_float(n, j);
    }
  }
}

template <int D, int KIND>
__global__ void __launch_bounds__(NW * 32) decode_attention_kernel(Args a) {
  using G = Geo<D, KIND>;
  constexpr int R = G::R, RB = G::RB, LPR = G::LPR, RPW = G::RPW;
  constexpr int U = G::U, N = G::N;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red_m[NW], red_l[NW], red_acc[NW][D];
  __shared__ int last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = (long long)b * a.H + h;

  // this CTA's chunk of [start, length), cut as split_chunks cuts it
  const int start = max(a.starts[b], 0);
  const int length = min(a.lengths[b], a.L);
  const int span = max(length - start, 0);
  int used = 1, lo = start, hi = start;
  if (span > 0) {
    const int n = max(1, min(a.n_splits, span / a.min_rows));
    const int chunk = (span + n - 1) / n;
    used = (span + chunk - 1) / chunk;
    lo = start + split * chunk;
    hi = min(lo + chunk, length);
  }
  if (split >= used) return;

  const long long row = ((long long)b * a.NL + a.layer) * a.H + h;
  const uint8_t* kp = a.k + row * a.L * RB;
  const uint8_t* vp = a.v + row * a.L * RB;
  const float* ksp = a.k_scale != nullptr ? a.k_scale + row * a.L : nullptr;
  const float* vsp = a.v_scale != nullptr ? a.v_scale + row * a.L : nullptr;
  const float* bp =
      a.bias != nullptr ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;

  // the lane's slice of q: columns [c0, c0 + N) of every row it reads
  const int c0 = (lane % LPR) * N, rl = lane / LPR;
  float qf[N];
  {
    const uint4* qv =
        reinterpret_cast<const uint4*>(a.q + bh * D + c0);
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 raw = qv[i];
      unpack<BF16, false>(raw, qf + 8 * i);
    }
  }

  uint8_t* ring = smem + warp * NS * G::STAGE;
  const int steps = (hi - lo + R - 1) / R;
  const int n_w = steps > warp ? (steps - warp + NW - 1) / NW : 0;
  const uint32_t col = (lane % LPR) * 16;

  // rows of warp step i into ring slot i % NS (rows past hi read as 0);
  // always one commit group, empty past the warp's last step
  auto fetch = [&](int i) {
    if (i < n_w) {
      const int base = lo + (warp + NW * i) * R;
      uint8_t* st = ring + (i % NS) * G::STAGE;
      const uint32_t sb = flash_sm90::smem_u32(st);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = u * RPW + rl, pos = base + rr;
        const bool ok = pos < hi;
        const long long off = (long long)(ok ? pos : 0) * RB + col;
        cp_async16(sb + rr * RB + col, kp + off, ok);
        if constexpr (!G::FUSED)
          cp_async16(sb + STAGE_K + rr * RB + col, vp + off, ok);
      }
      if (lane < R) {
        const int pos = base + lane;
        const bool ok = pos < hi;
        const int p = ok ? pos : 0;
        if (ksp != nullptr) {
          cp_async4(sb + G::SC + 4 * lane, ksp + p, ok);
          cp_async4(sb + G::SC + 4 * (R + lane), vsp + p, ok);
        }
        if (bp != nullptr) cp_async4(sb + G::SC + 4 * (2 * R + lane), bp + p, ok);
      }
    }
    cp_async_commit();
  };

  float m = -INFINITY, l = 0.f, acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;

#pragma unroll
  for (int i = 0; i < NS - 1; ++i) fetch(i);
  for (int i = 0; i < n_w; ++i) {
    fetch(i + NS - 1);  // into the slot step i - 1 left
    cp_async_wait<NS - 1>();
    __syncwarp();       // the scales came through other lanes
    const uint8_t* st = ring + (i % NS) * G::STAGE;
    const float* sks = reinterpret_cast<const float*>(st + G::SC);
    const float* svs = sks + R;
    const float* sbias = sks + 2 * R;
    const int base = lo + (warp + NW * i) * R;

    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = u * RPW + rl;
      const uint4 raw = *reinterpret_cast<const uint4*>(st + rr * RB + col);
      float kf[N];
      unpack<KIND, false>(raw, kf);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) dot = fmaf(qf[j], kf[j], dot);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (ksp != nullptr) dot *= sks[rr];
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
    for (int j = 0; j < N; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = u * RPW + rl;
      const float p = expf(s[u] - m_new);
      l += p;
      float pq = ksp != nullptr ? p * svs[rr] : p;
      pq = __bfloat162float(__float2bfloat16(pq));
      const uint4 raw = *reinterpret_cast<const uint4*>(
          st + (G::FUSED ? 0 : STAGE_K) + rr * RB + col);
      float vf[N];
      unpack<KIND, true>(raw, vf);
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = fmaf(pq, vf[j], acc[j]);
    }
    __syncwarp();  // the slot is refilled by the next step's fetch
  }
  cp_async_wait<0>();

  // the row groups' sums (every lane of a row group holds the same l)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int j = 0; j < N; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  if (lane < LPR)
#pragma unroll
    for (int j = 0; j < N; ++j) red_acc[warp][c0 + j] = acc[j];
  __syncthreads();

  // the warps' sums in warp order; thread t < D holds column t
  float mc = red_m[0], lc = 0.f, ac = 0.f;
#pragma unroll
  for (int w = 1; w < NW; ++w) mc = fmaxf(mc, red_m[w]);
  if (tid < D) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (red_m[w] == -INFINITY) continue;  // a warp without rows
      const float f = expf(red_m[w] - mc);
      lc += red_l[w] * f;
      ac = fmaf(red_acc[w][tid], f, ac);
    }
  }
  __nv_bfloat16* op = a.out + bh * D;
  if (used == 1) {  // the whole span in this CTA (or none: zeros)
    if (tid < D) op[tid] = __float2bfloat16(ac * (lc == 0.f ? 1.f : 1.f / lc));
    return;
  }
  float* part = a.ws + (bh * a.n_splits + split) * (2 + D);
  if (tid < D) part[2 + tid] = ac;
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
  if (!last || tid >= D) return;
  __threadfence();
  // every chunk holds a row: each m is finite
  const float* parts = a.ws + bh * a.n_splits * (2 + D);
  float mg = -INFINITY;
  for (int s = 0; s < used; ++s) mg = fmaxf(mg, __ldcg(parts + s * (2 + D)));
  float lg = 0.f, ag = 0.f;
  for (int s = 0; s < used; ++s) {
    const float* ps = parts + s * (2 + D);
    const float f = expf(__ldcg(ps) - mg);
    lg += __ldcg(ps + 1) * f;
    ag = fmaf(__ldcg(ps + 2 + tid), f, ag);
  }
  op[tid] = __float2bfloat16(ag * (lg == 0.f ? 1.f : 1.f / lg));
}

template <int D, int KIND>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = Geo<D, KIND>::SMEM;
  cudaError_t err =
      flash_sm90::allow_smem<decode_attention_kernel<D, KIND>>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_splits, a.H, B);
  decode_attention_kernel<D, KIND><<<grid, NW * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, int kv_kind, const void* bias, long long bias_sb,
    long long bias_sh, const void* lengths, const void* starts, void* out,
    void* ws, void* counters, int B, int H, int NL, int layer, int L, int D,
    int n_splits, int min_rows, float sm_scale, void* stream) {
  // kv_kind: 0 bf16, 1 int8 with scales, 2 fused int4 with scales (read
  // through k alone)
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const uint8_t*)k;
  a.v = (const uint8_t*)(kv_kind == INT4 ? k : v);
  a.k_scale = (const float*)k_scale;
  a.v_scale = (const float*)v_scale;
  a.bias = (const float*)bias;
  a.bias_sb = bias_sb;
  a.bias_sh = bias_sh;
  a.lengths = (const int*)lengths;
  a.starts = (const int*)starts;
  a.out = (__nv_bfloat16*)out;
  a.ws = (float*)ws;
  a.counters = (int*)counters;
  a.H = H;
  a.NL = NL;
  a.layer = layer;
  a.L = L;
  a.n_splits = n_splits;
  a.min_rows = min_rows;
  a.sm_scale = sm_scale;
  if (n_splits < 1 || min_rows < 1 ||
      (n_splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) {
    if (kv_kind == INT4) return launch<128, INT4>(a, B, st);
    if (kv_kind == INT8) return launch<128, INT8>(a, B, st);
    if (kv_kind == BF16) return launch<128, BF16>(a, B, st);
  }
  if (D == 64) {
    if (kv_kind == INT4) return launch<64, INT4>(a, B, st);
    if (kv_kind == INT8) return launch<64, INT8>(a, B, st);
    if (kv_kind == BF16) return launch<64, BF16>(a, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
