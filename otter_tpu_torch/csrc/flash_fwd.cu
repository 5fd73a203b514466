// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out + f32 LSE.
//
// Replaces the Pallas TPU kernel otter_tpu/ops/flash_attention.py:_fwd_kernel
// (launched from _fwd, entry point flash_attention). Same function:
//   q is pre-scaled by sm_scale*log2(e), rounded to bf16 (q's dtype);
//   s = max(q.k (f32) + bias*log2(e), mask_value); s = mask ? s : mask_value,
//   where the mask is the id comparison (eq / ge) AND the causal condition
//   col <= row (the max keeps a bias that masks, -0.7 f32-max, finite
//   once scaled by log2(e), so a tile it masks whole leaves m finite);
//   base-2 online softmax with f32 statistics (2^x on the special-function
//   unit, a p below 2^-126 flushed to 0); p is rounded to bf16 before
//   p.v; out = acc / l (l == 0 -> 1); lse = ln2 * (m + log2 l), natural log.
// Keys past S_k are excluded outright (p = 0), which is what the TPU path's
// PAD_ID ids did; with causal attention a query tile stops at the key tile
// that holds its diagonal.
//
// What bounds it on the H100: 4 S_q S_k D operations per (batch, head)
// (half of that when causal) against 2 (2 S_q + 2 S_k) D bytes, so at
// S >= 128 it is bound by operations, at bf16 tensor-core rate (989
// TFLOP/s). Both products run on the tensor cores (wgmma), the logits and
// probabilities never leave registers, and the loads of the next key tile
// overlap the products on this one.
//
// Design. One CTA of two warpgroups (256 threads) per (128-query tile,
// head, batch); each warpgroup owns 64 query rows. The sequential kv-grid
// axis and the m/l/acc VMEM scratch of the TPU kernel become a loop over
// 64-key tiles inside the CTA:
//   - q (once) and the k/v tiles arrive by 16-byte cp.async (zero-filled
//     past S) in bf16 shared memory, swizzled as wgmma's descriptors want
//     (flash_sm90.cuh), through a ring of four stages: tile j + 2 is in
//     flight while tile j is multiplied. q is scaled by sm_scale*log2(e)
//     and rounded to bf16 in shared memory once.
//   - S = q k^T: wgmma m64n64k16, both operands in shared memory, f32 in
//     registers.
//   - A bias broadcast over rows (ALiBi, [B|1, H|1, 1, S_k]) and the key
//     tile's kv ids are staged in shared memory with the tile, once a tile;
//     a bias with a query axis (a second instantiation) is read from
//     device memory per logit.
//   - Bias, mask and online softmax in registers, branch-free (row max and
//     sum over the 4 lanes that share a row): a branch per logit cost more
//     than the products, and a branch between a product's start and its
//     wait makes ptxas serialize the products. P is rounded to bf16 in
//     registers and is the A operand of O += P v (wgmma from registers, v
//     MN-major in shared memory).
//   - Tile j's P v is started beside tile j + 1's q k^T, so the softmax of
//     tile j + 1 runs while the tensor cores do P v.
//   - The output is staged in shared memory and leaves in 16-byte stores;
//     LSE as f32.
// Causal CTAs are launched longest first (the last query tile first); at
// head dims up to 64 two CTAs share an SM.
#include "flash_sm90.cuh"

#include <math.h>

namespace {

using namespace flash_sm90;

constexpr int BQ = 128;  // query rows a CTA (64 a warpgroup)
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;

struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;
  long long bias_sb, bias_sh, bias_sq;
  const int* q_ids;
  const int* kv_ids;
  int ids_mode;  // 0 none, 1 eq, 2 ge
  __nv_bfloat16* out;
  float* lse;
  int H, Sq, Sk, causal;
  float q_scale, mask_value;
};

// shared memory: q [BQ x D] | NS stages of k, v [BK x D] | NS stages of
// the bias row [BK] f32 and the kv ids [BK] i32
template <int D>
struct FwdSmem {
  static constexpr int NS = 4;
  static constexpr int KV = BQ * D * 2;
  static constexpr int V = BK * D * 2;        // v after k in a stage
  static constexpr int STAGE = 2 * BK * D * 2;
  static constexpr int ROWS = KV + NS * STAGE;
  static constexpr int BYTES = ROWS + NS * 2 * BK * 4;
};

// the q tile times `scale`, rounded to bf16, in place
template <int D>
__device__ __forceinline__ void scale_q(uint8_t* tile, float scale, int tid) {
  constexpr int VPR = D / 8;
  for (int e = tid; e < BQ * VPR; e += NT) {
    uint4* p = reinterpret_cast<uint4*>(
        tile + Tile<D>::offset(BQ, e / VPR, (e % VPR) * 8));
    uint4 x = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *p = x;
  }
}

// kFullBias: the bias has a query axis and is read from device memory per
// logit; otherwise a bias row, if any, is staged with the key tile. The
// walk is straight-line code with no branch between a product's start and
// its wait, which ptxas needs to keep the products asynchronous.
template <int D, bool kFullBias>
__global__ void __launch_bounds__(NT, D <= 64 ? 2 : 1)
    flash_fwd_kernel(FwdArgs a) {
  using L = Tile<D>;
  using S = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sb = smem_u32(smem);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int tq = t & 3;
  const long long bh = (long long)b * a.H + h;
  const int Sq = a.Sq, Sk = a.Sk;
  const __nv_bfloat16* qp = a.q + bh * Sq * D;
  const __nv_bfloat16* kp = a.k + bh * Sk * D;
  const __nv_bfloat16* vp = a.v + bh * Sk * D;
  const int q0 = qt * BQ, qw0 = q0 + wg * 64;
  const int n_kv = cdiv(Sk, BK);
  const int last = a.causal ? min(n_kv - 1, (q0 + BQ - 1) / BK) : n_kv - 1;
  // a warpgroup's rows see no key past this tile: later tiles count as
  // fully masked for it (p = 0), as if its walk stopped there
  const int last_w = a.causal ? min(n_kv - 1, (qw0 + 63) / BK) : n_kv - 1;
  const bool live = qw0 < Sq;
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + b * a.bias_sb + h * a.bias_sh;
  const bool bias_row = a.bias != nullptr && a.bias_sq == 0;
  const int* kid_b = a.ids_mode != 0 ? a.kv_ids + (long long)b * Sk : nullptr;

  auto load_kv = [&](int kt) {
    const int s = kt % S::NS;
    load_kv_stage<D, NT>(sb + S::KV + s * S::STAGE, S::V,
                         sb + S::ROWS + s * 2 * BK * 4, kp, vp,
                         bias_row ? bias_bh : nullptr, kid_b, kt * BK, Sk,
                         tid);
  };

  int row[2], brow[2], qid[2];
  float m_i[2], l_i[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = qw0 + (t >> 5) * 16 + ((t & 31) >> 2) + 8 * i;
    brow[i] = row[i] < Sq ? row[i] : Sq - 1;
    qid[i] = (a.ids_mode != 0 && row[i] < Sq)
                 ? a.q_ids[(long long)b * Sq + row[i]] : 0;
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
  }
  // ids that mask nothing for a warpgroup are dropped for it
  const int ids_mode =
      a.ids_mode == 0 ? 0
                      : live_ids_mode<NT>(a.ids_mode, kid_b,
                                          min(Sk, (last + 1) * BK), row, qid,
                                          Sq, tid, wg);
  float o[L::NCH][L::CW / 2];
#pragma unroll
  for (int ch = 0; ch < L::NCH; ++ch)
#pragma unroll
    for (int e = 0; e < L::CW / 2; ++e) o[ch][e] = 0.f;
  float sc[32];
  uint32_t pa[4][4];  // P of a tile, bf16, waiting for its v

  // S = q k^T of tile kt into sc (started, committed, not waited)
  auto start_qk = [&](int kt) {
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    fence_regs(sc);
    wgmma_fence();
    wgmma_ss_tile<D>(sc, sb, BQ, wg * 64,
                     sb + S::KV + (kt % S::NS) * S::STAGE, BK, 0);
    wgmma_commit();
  };
  // bias, mask and the online softmax of tile kt, branch-free but for one
  // branch uniform over the warpgroup: sc becomes p (f32), alpha the old
  // sum's factor.
  // Element e is row row[(e >> 1) & 1], key k0 + 8 (e >> 2) + 2 tq + (e & 1).
  float alpha[2];
  auto softmax = [&](int kt) {
    const int k0 = kt * BK, s = kt % S::NS;
    const float* bsm =
        reinterpret_cast<const float*>(smem + S::ROWS + s * 2 * BK * 4);
    const int* ksm = reinterpret_cast<const int*>(bsm + BK);
    const int mode = ids_mode;
    const bool causal = a.causal, skip = kt > last_w;
    if (kFullBias | bias_row) {  // uniform over the CTA
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int cl = 8 * (e >> 2) + 2 * tq + (e & 1);
        if constexpr (kFullBias)  // keys past S_k are masked: read a real one
          sc[e] += bias_bh[brow[(e >> 1) & 1] * a.bias_sq +
                           min(k0 + cl, Sk - 1)] * LOG2E;
        else
          sc[e] += bsm[cl] * LOG2E;
        sc[e] = fmaxf(sc[e], a.mask_value);
      }
    }
    // a branch uniform over the warpgroup: tiles inside S_k, below the
    // diagonal and without ids need no mask
    if ((mode != 0) | skip | (k0 + BK > Sk) | (causal & (k0 + BK - 1 > qw0))) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1, cl = 8 * (e >> 2) + 2 * tq + (e & 1);
        const int col = k0 + cl, kid = ksm[cl];
        const bool id_ok =
            (mode == 0) | (mode == 1 ? qid[i] == kid : qid[i] >= kid);
        const bool ok = id_ok & (!causal | (col <= row[i]));
        const float x = ok ? sc[e] : a.mask_value;
        sc[e] = (skip | (col >= Sk)) ? -INFINITY : x;
      }
    }
    // row max and sum as trees of four partials a row (short dependency
    // chains: the softmax is the longest part of an iteration)
    float mx[2][4], rs[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx[i][j] = -INFINITY;
        rs[i][j] = 0.f;
      }
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e >> 1) & 1][(e >> 2) & 3] =
          fmaxf(mx[(e >> 1) & 1][(e >> 2) & 3], sc[e]);
    // every tile a warpgroup does not skip holds a key < Sk, and tile 0 is
    // never skipped, so m is finite from the first tile on
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(
          m_i[i], quad_max(fmaxf(fmaxf(mx[i][0], mx[i][1]),
                                 fmaxf(mx[i][2], mx[i][3]))));
      alpha[i] = exp2_ftz(m_i[i] - m_new);
      m_i[i] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      sc[e] = exp2_ftz(sc[e] - m_i[i]);
      rs[i][(e >> 2) & 3] += sc[e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l_i[i] = alpha[i] * l_i[i] +
               quad_sum((rs[i][0] + rs[i][1]) + (rs[i][2] + rs[i][3]));
  };
  // o += P v of tile kt (started, committed, not waited)
  auto start_pv = [&](int kt) {
    const uint32_t vb = sb + S::KV + (kt % S::NS) * S::STAGE + S::V;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tile<D>(o, pa[kk], vb, BK, kk * 16);
    wgmma_commit();
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int ch = 0; ch < L::NCH; ++ch) fence_regs(o[ch]);
  };
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int ch = 0; ch < L::NCH; ++ch)
#pragma unroll
      for (int e = 0; e < L::CW / 2; ++e) o[ch][e] *= alpha[(e >> 1) & 1];
    pack_a(sc, pa);
  };

  // Tile kt's P v is started in iteration kt + 1, beside that iteration's
  // q k^T, so the softmax of tile kt + 1 overlaps it on the tensor cores.
  // A stage is refilled two iterations after its tile's q k^T and one
  // after its P v: four stages. Every warpgroup runs every tile (a
  // warpgroup past its rows or its diagonal computes p = 0), so that each
  // product's start and wait stay in straight-line code.
  load_tile_async<D, BQ, NT>(sb, qp, q0, Sq, tid);
  load_kv(0);
  cp_async_commit();
  if (last >= 1) {
    load_kv(1);
    cp_async_commit();
  }
  if (last >= 1) cp_async_wait<1>();
  else cp_async_wait<0>();
  __syncthreads();
  scale_q<D>(smem, a.q_scale, tid);
  fence_proxy_async();
  __syncthreads();
  if (last >= 2) {
    load_kv(2);
    cp_async_commit();
  }
  start_qk(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  rescale_and_pack();
  for (int kt = 1; kt <= last; ++kt) {
    if (kt < last) cp_async_wait<1>();
    else cp_async_wait<0>();
    fence_proxy_async();
    // tile kt is visible; every warpgroup is past iteration kt - 1, so the
    // P v of tile kt - 2 is done and its stage may be refilled
    __syncthreads();
    if (kt + 2 <= last) {
      load_kv(kt + 2);
      cp_async_commit();
    }
    fence_o();
    start_qk(kt);   // its wgmma_fence also covers pa and o
    start_pv(kt - 1);
    wgmma_wait<1>();
    fence_regs(sc);
    softmax(kt);
    wgmma_wait<0>();
    fence_o();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    rescale_and_pack();
  }
  fence_o();
  wgmma_fence();
  start_pv(last);
  wgmma_wait<0>();
  fence_o();
  __syncthreads();  // all of shared memory is free for the output

  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem) + wg * 64 * (D + 8);
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (l_i[i] == 0.f) l_i[i] = 1.f;
    inv[i] = 1.f / l_i[i];
  }
  if (live) stage_acc<D>(st, o, inv, t);
  __syncthreads();
  if (live) {
    store_rows<D>(a.out + bh * Sq * D, st, qw0, Sq, t);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (tq == 0 && row[i] < Sq)
        a.lse[bh * Sq + row[i]] = LN2 * (m_i[i] + log2f(l_i[i]));
  }
}

template <int D, bool kFullBias>
int launch_variant(const FwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = FwdSmem<D>::BYTES + 1024;  // + alignment to 1024
  cudaError_t err = allow_smem<flash_fwd_kernel<D, kFullBias>>((int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(a.Sq, BQ), a.H, B);
  flash_fwd_kernel<D, kFullBias><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const FwdArgs& a, int B, cudaStream_t stream) {
  return a.bias != nullptr && a.bias_sq != 0
             ? launch_variant<D, true>(a, B, stream)
             : launch_variant<D, false>(a, B, stream);
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* bias, long long bias_sb,
                              long long bias_sh, long long bias_sq,
                              const void* q_ids, const void* kv_ids,
                              int ids_mode, void* out, void* lse, int B,
                              int H, int Sq, int Sk, int D, int causal,
                              float q_scale, float mask_value, void* stream) {
  FwdArgs a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.bias = (const float*)bias;
  a.bias_sb = bias_sb;
  a.bias_sh = bias_sh;
  a.bias_sq = bias_sq;
  a.q_ids = (const int*)q_ids;
  a.kv_ids = (const int*)kv_ids;
  a.ids_mode = ids_mode;
  a.out = (__nv_bfloat16*)out;
  a.lse = (float*)lse;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.q_scale = q_scale;
  a.mask_value = mask_value;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(a, B, st);
    case 32: return launch<32>(a, B, st);
    case 48: return launch<48>(a, B, st);
    case 64: return launch<64>(a, B, st);
    case 80: return launch<80>(a, B, st);
    case 96: return launch<96>(a, B, st);
    case 112: return launch<112>(a, B, st);
    case 128: return launch<128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
