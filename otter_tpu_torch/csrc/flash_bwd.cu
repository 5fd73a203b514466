// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/do in, f32 LSE
// and di in, bf16 dk/dv (one kernel) and dq (another) out.
//
// Replaces the Pallas TPU kernels otter_tpu/ops/flash_attention.py:
// _bwd_dkv_kernel and _bwd_dq_kernel (launched from _bwd through
// _bwd_pallas_call). Same function, per (q, k) pair:
//   s  = (q.k) * sm_scale + bias      (f32 products, q unscaled)
//   s  = mask ? s : mask_value        (ids eq/ge AND causal col <= row)
//   p  = exp(s - lse)                 (f32)
//   dp = do.v                         (f32)
//   ds = p * (dp - di) * sm_scale
//   dv += p^T do, dk += ds^T q, dq += ds k   (f32 accumulators)
// with two refinements that make it the derivative of the forward in
// csrc/flash_fwd.cu: a row that may attend no key (lse below
// 0.5 * mask_value; its forward averaged v over the S_k real keys) gets
// p = 1/S_k, and ds = 0 wherever the mask holds (a masked logit is a
// constant). Keys past S_k and rows past S_q are bounds-checked out: they
// add nothing and are never written.
//
// What bounds it on the H100: dK/dV does 4 and dQ 3 products of
// [S_q x S_k x D] (half when causal) on tiles that sit in shared memory,
// so both are bound by operations, not bytes.
//
// dK/dV runs its four products on the tensor cores (wgmma, the pieces in
// flash_sm90.cuh). One CTA of one warpgroup (128 threads) per (64-key
// tile, head, batch); k and v stay in bf16 shared memory for the whole
// walk, and the 64-query tiles of q and do, with their lse / di / q-id
// rows, stream through a two-stage ring of 16-byte cp.async copies (tile
// j + 1 in flight while tile j is multiplied), starting at the diagonal
// tile when causal. S^T = k q^T and dP^T = v do^T are wgmma products of
// two shared-memory tiles into f32 registers; P^T and dS^T are formed in
// registers with the dead-row and masked-ds rules, rounded to bf16 and fed
// back as the A operand of dv += P^T do and dk += dS^T q (do and q read
// MN-major from the same shared tiles). The f32 accumulators live in
// registers for the whole walk and leave through shared memory in 16-byte
// stores. Numerics choice: the JAX kernel keeps p and ds in f32 for the
// two accumulating products; here they are rounded to bf16 (the tensor
// cores' input type) and the sums stay f32. That moves dk/dv by about
// bf16's 2^-9 relative per term, inside the limits the port holds the
// kernel to (2e-2 max|plain| + 2e-2 |plain|, and the train step's).
//
// dQ is the forward's walk with one more product, on the tensor cores as
// well: one CTA of two warpgroups (256 threads) per (128-query tile, head,
// batch), each warpgroup owning 64 query rows. q and do (bf16) stay in
// shared memory for the whole walk, the lse / di / q-id rows in registers;
// the 64-key tiles of k and v, with their bias row and kv ids, stream
// through the forward's ring of four cp.async stages (tile j + 2 in flight
// while tile j is multiplied), stopping at the diagonal tile when causal.
// Per tile, S = q k^T and dP = do v^T are wgmma products of two shared
// tiles into f32 registers; dS = exp(S sm_scale + bias - lse) (dP - di) is
// formed in registers (0 wherever the mask holds, which also covers rows
// that attend no key), rounded to bf16 and fed back as the register A
// operand of dq += dS k, with k read MN-major from the tile already in
// shared memory (the forward's P v trick). Tile j's dS k is started beside
// tile j + 1's two products, so dS of tile j + 1 is formed while the
// tensor cores run it. sm_scale multiplies dq once, at the store; the f32
// accumulator lives in registers for the whole walk and leaves through
// shared memory in 16-byte stores. Registers a thread: 32 (S) + 32 (dP) +
// D / 2 (dq) f32 and 16 of the bf16 A fragment, which fit the forward's
// CTA shape. As in the forward, bias kind and "needs a mask" are branches
// uniform over a warpgroup around branch-free loops, ids that mask nothing
// for a warpgroup are dropped for it, and every warpgroup runs every tile
// (a tile past its rows or its diagonal gets dS = 0) so that each wgmma is
// started in straight-line code: ptxas serializes wgmma behind a branch.
// Numerics choice: the JAX kernel keeps ds in f32 for dq += ds k; here dS
// is rounded to bf16 (the tensor cores' input type), as dK/dV rounds P and
// dS, and the sum stays f32.
#include "flash_sm90.cuh"

#include <math.h>

namespace {

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;
  long long bias_sb, bias_sh, bias_sq;
  const int* q_ids;
  const int* kv_ids;
  int ids_mode;  // 0 none, 1 eq, 2 ge
  const float* lse;
  const float* di;
  const __nv_bfloat16* dout;
  int H, Sq, Sk, causal;
  float sm_scale, mask_value;
};

// shared memory of the dK/dV kernel: k, v [64 x D] | stage 0: q, do
// [64 x D], lse, di, q ids [64] | stage 1 (stages padded to 1024 bytes)
template <int D>
struct DkvSmem {
  static constexpr int V = 64 * D * 2;
  static constexpr int STAGE0 = 2 * 64 * D * 2;
  static constexpr int DO = 64 * D * 2;       // do after q in a stage
  static constexpr int ROWS = 2 * 64 * D * 2; // lse, di, q ids after do
  static constexpr int STAGE = ROWS + 1024;
  static constexpr int BYTES = STAGE0 + 2 * STAGE;
};

template <int D>
__global__ void __launch_bounds__(128, 1) flash_bwd_dkv_kernel(
    Args a, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
  using namespace flash_sm90;
  using L = Tile<D>;
  using S = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sb = smem_u32(smem);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, g = (t & 31) >> 2, tq = t & 3, w = t >> 5;
  const long long bh = (long long)b * a.H + h;
  const int Sq = a.Sq, Sk = a.Sk;
  const int k0 = kt * 64;
  const __nv_bfloat16* qp = a.q + bh * Sq * D;
  const __nv_bfloat16* op = a.dout + bh * Sq * D;
  const float* lse_bh = a.lse + bh * Sq;
  const float* di_bh = a.di + bh * Sq;
  const int* qid_b = a.ids_mode != 0 ? a.q_ids + (long long)b * Sq : nullptr;
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + b * a.bias_sb + h * a.bias_sh;
  const bool bias_row = a.bias != nullptr && a.bias_sq == 0;

  auto load_q = [&](int qt, int s) {
    const int q0 = qt * 64;
    const uint32_t base = sb + S::STAGE0 + s * S::STAGE;
    load_tile_async<D, 64, 128>(base, qp, q0, Sq, t);
    load_tile_async<D, 64, 128>(base + S::DO, op, q0, Sq, t);
    const uint32_t rows = base + S::ROWS;
    if (t < 64) {
      load_row_async(rows, lse_bh, q0, Sq, t);
      load_row_async(rows + 256, di_bh, q0, Sq, t);
    } else if (qid_b != nullptr) {
      load_row_async(rows + 512, qid_b, q0, Sq, t - 64);
    }
  };

  // the thread's two key rows: their kv ids and, for a bias broadcast over
  // query rows, their bias
  int key[2], kid[2];
  float kbias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + w * 16 + g + 8 * i;
    const bool ok = key[i] < Sk;
    kid[i] = (a.ids_mode != 0 && ok) ? a.kv_ids[(long long)b * Sk + key[i]]
                                     : 0;
    kbias[i] = (bias_row && ok) ? bias_bh[key[i]] : 0.f;
  }
  float dka[L::NCH][L::CW / 2], dva[L::NCH][L::CW / 2];
#pragma unroll
  for (int ch = 0; ch < L::NCH; ++ch)
#pragma unroll
    for (int e = 0; e < L::CW / 2; ++e) dka[ch][e] = dva[ch][e] = 0.f;

  const float dead_below = 0.5f * a.mask_value;
  const float inv_sk = 1.f / (float)Sk;
  const int n_q = cdiv(Sq, 64);
  // causal: query tiles before the one holding row k0 see none of these keys
  const int first = a.causal ? k0 / 64 : 0;
  load_tile_async<D, 64, 128>(sb, a.k + bh * Sk * D, k0, Sk, t);
  load_tile_async<D, 64, 128>(sb + S::V, a.v + bh * Sk * D, k0, Sk, t);
  if (first < n_q) load_q(first, 0);
  cp_async_commit();
  for (int qt = first; qt < n_q; ++qt) {
    const int s = (qt - first) & 1;
    if (qt + 1 < n_q) {
      load_q(qt + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    const int q0 = qt * 64;
    const uint32_t qb = sb + S::STAGE0 + s * S::STAGE;
    const float* lsm = reinterpret_cast<const float*>(
        smem + S::STAGE0 + s * S::STAGE + S::ROWS);
    const float* dsm = lsm + 64;
    const int* qsm = reinterpret_cast<const int*>(lsm + 128);

    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    wgmma_ss_tile<D>(st, sb, 64, 0, qb, 64, 0);             // S^T = k q^T
    wgmma_ss_tile<D>(dpt, sb + S::V, 64, 0, qb + S::DO, 64, 0);  // v do^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T, branch-free (a branch per element costs more than the
    // products); the bias is a branch on a value uniform over the CTA.
    // Element e is key row key[(e >> 1) & 1], query q0 + 8 (e >> 2) +
    // 2 tq + (e & 1).
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] *= a.sm_scale;
    if (bias_bh != nullptr) {
      if (bias_row) {
#pragma unroll
        for (int e = 0; e < 32; ++e) st[e] += kbias[(e >> 1) & 1];
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          // rows past S_q and keys past S_k get p = 0 below
          const int qrow = min(q0 + 8 * (e >> 2) + 2 * tq + (e & 1), Sq - 1);
          st[e] += bias_bh[qrow * a.bias_sq + min(key[(e >> 1) & 1], Sk - 1)];
        }
      }
    }
    {
      const int mode = a.ids_mode;
      const bool causal = a.causal;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1, cl = 8 * (e >> 2) + 2 * tq + (e & 1);
        const int qrow = q0 + cl, qid = qsm[cl];
        const float lq = lsm[cl];
        const bool valid = (qrow < Sq) & (key[i] < Sk);
        const bool id_ok = (mode == 0) |
                           (mode == 1 ? qid == kid[i] : qid >= kid[i]);
        const bool ok = valid & id_ok & (!causal | (key[i] <= qrow));
        const float p = expf(st[e] - lq);
        // a row that attends no key: the forward averaged v over them all
        const float dead = (valid & (lq < dead_below)) ? inv_sk : 0.f;
        st[e] = ok ? p : dead;
        dpt[e] = ok ? p * (dpt[e] - dsm[cl]) * a.sm_scale : 0.f;
      }
    }
    uint32_t pa[4][4], sa[4][4];
    pack_a(st, pa);
    pack_a(dpt, sa);
#pragma unroll
    for (int ch = 0; ch < L::NCH; ++ch) {
      fence_regs(dva[ch]);
      fence_regs(dka[ch]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tile<D>(dva, pa[kk], qb + S::DO, 64, kk * 16);  // P^T do
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tile<D>(dka, sa[kk], qb, 64, kk * 16);          // dS^T q
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int ch = 0; ch < L::NCH; ++ch) {
      fence_regs(dva[ch]);
      fence_regs(dka[ch]);
    }
    __syncthreads();  // stage s is refilled by the next iteration
  }
  cp_async_wait<0>();
  __syncthreads();

  __nv_bfloat16* st_k = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* st_v = st_k + 64 * (D + 8);
  const float one[2] = {1.f, 1.f};
  stage_acc<D>(st_k, dka, one, t);
  stage_acc<D>(st_v, dva, one, t);
  __syncthreads();
  store_rows<D>(dk + bh * Sk * D, st_k, k0, Sk, t);
  store_rows<D>(dv + bh * Sk * D, st_v, k0, Sk, t);
}

// shared memory of the dQ kernel: q, do [DQ_BQ x D] | NS stages of k, v
// [64 x D] | NS stages of the bias row [64] f32 and the kv ids [64] i32
constexpr int DQ_BQ = 128;  // query rows a CTA (64 a warpgroup)
constexpr int DQ_NT = 256;

template <int D>
struct DqSmem {
  static constexpr int NS = 4;
  static constexpr int DO = DQ_BQ * D * 2;      // do after q
  static constexpr int KV = 2 * DQ_BQ * D * 2;  // the stages after do
  static constexpr int V = 64 * D * 2;          // v after k in a stage
  static constexpr int STAGE = 2 * 64 * D * 2;
  static constexpr int ROWS = KV + NS * STAGE;
  static constexpr int BYTES = ROWS + NS * 2 * 64 * 4;
};

// kFullBias: the bias has a query axis and is read from device memory per
// logit; otherwise a bias row, if any, is staged with the key tile.
template <int D, bool kFullBias>
__global__ void __launch_bounds__(DQ_NT, 1)
    flash_bwd_dq_kernel(Args a, __nv_bfloat16* __restrict__ dq) {
  using namespace flash_sm90;
  using L = Tile<D>;
  using S = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t sb = smem_u32(smem);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int tq = t & 3;
  const long long bh = (long long)b * a.H + h;
  const int Sq = a.Sq, Sk = a.Sk;
  const __nv_bfloat16* kp = a.k + bh * Sk * D;
  const __nv_bfloat16* vp = a.v + bh * Sk * D;
  const int q0 = qt * DQ_BQ, qw0 = q0 + wg * 64;
  const int n_kv = cdiv(Sk, 64);
  const int last = a.causal ? min(n_kv - 1, (q0 + DQ_BQ - 1) / 64) : n_kv - 1;
  // a warpgroup's rows see no key past this tile: later tiles count as
  // fully masked for it (dS = 0)
  const int last_w = a.causal ? min(n_kv - 1, (qw0 + 63) / 64) : n_kv - 1;
  const bool live = qw0 < Sq;
  const float* bias_bh =
      a.bias == nullptr ? nullptr : a.bias + b * a.bias_sb + h * a.bias_sh;
  const bool bias_row = a.bias != nullptr && a.bias_sq == 0;
  const int* kid_b = a.ids_mode != 0 ? a.kv_ids + (long long)b * Sk : nullptr;

  auto load_kv = [&](int kt) {
    const int s = kt % S::NS;
    load_kv_stage<D, DQ_NT>(sb + S::KV + s * S::STAGE, S::V,
                            sb + S::ROWS + s * 2 * 64 * 4, kp, vp,
                            bias_row ? bias_bh : nullptr, kid_b, kt * 64, Sk,
                            tid);
  };

  // the thread's two query rows: lse in base 2, di, q id
  int row[2], brow[2], qid[2];
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = qw0 + (t >> 5) * 16 + ((t & 31) >> 2) + 8 * i;
    const bool ok = row[i] < Sq;
    brow[i] = ok ? row[i] : Sq - 1;
    lse2[i] = ok ? a.lse[bh * Sq + row[i]] * LOG2E : 0.f;
    di[i] = ok ? a.di[bh * Sq + row[i]] : 0.f;
    qid[i] = (a.ids_mode != 0 && ok) ? a.q_ids[(long long)b * Sq + row[i]]
                                      : 0;
  }
  // ids that mask nothing for a warpgroup are dropped for it
  const int ids_mode =
      a.ids_mode == 0 ? 0
                      : live_ids_mode<DQ_NT>(a.ids_mode, kid_b,
                                             min(Sk, (last + 1) * 64), row,
                                             qid, Sq, tid, wg);
  float dqa[L::NCH][L::CW / 2];
#pragma unroll
  for (int ch = 0; ch < L::NCH; ++ch)
#pragma unroll
    for (int e = 0; e < L::CW / 2; ++e) dqa[ch][e] = 0.f;
  float sc[32], dp[32];
  uint32_t sa[4][4];  // dS of a tile, bf16, waiting for its k
  const float scale2 = a.sm_scale * LOG2E;

  // S = q k^T and dP = do v^T of tile kt (started, committed, not waited)
  auto start_sdp = [&](int kt) {
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    const uint32_t kb = sb + S::KV + (kt % S::NS) * S::STAGE;
    wgmma_ss_tile<D>(sc, sb, DQ_BQ, wg * 64, kb, 64, 0);
    wgmma_ss_tile<D>(dp, sb + S::DO, DQ_BQ, wg * 64, kb + S::V, 64, 0);
    wgmma_commit();
  };
  // dS / sm_scale of tile kt into sc, branch-free but for branches uniform
  // over the warpgroup. Element e is row row[(e >> 1) & 1], key
  // k0 + 8 (e >> 2) + 2 tq + (e & 1).
  auto grads = [&](int kt) {
    const int k0 = kt * 64, s = kt % S::NS;
    const float* bsm =
        reinterpret_cast<const float*>(smem + S::ROWS + s * 2 * 64 * 4);
    const int* ksm = reinterpret_cast<const int*>(bsm + 64);
    const int mode = ids_mode;
    const bool causal = a.causal, skip = kt > last_w;
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= scale2;
    if (kFullBias | bias_row) {  // uniform over the CTA
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int cl = 8 * (e >> 2) + 2 * tq + (e & 1);
        if constexpr (kFullBias)  // keys past S_k are masked: read a real one
          sc[e] += bias_bh[brow[(e >> 1) & 1] * a.bias_sq +
                           min(k0 + cl, Sk - 1)] * LOG2E;
        else
          sc[e] += bsm[cl] * LOG2E;
      }
    }
    // tiles inside S_k, below the diagonal and without ids need no mask
    if ((mode != 0) | skip | (k0 + 64 > Sk) | (causal & (k0 + 63 > qw0))) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1, cl = 8 * (e >> 2) + 2 * tq + (e & 1);
        const int col = k0 + cl, kid = ksm[cl];
        const bool id_ok =
            (mode == 0) | (mode == 1 ? qid[i] == kid : qid[i] >= kid);
        const bool ok = id_ok & (!causal | (col <= row[i])) & !skip &
                        (col < Sk);
        sc[e] = ok ? sc[e] : -INFINITY;  // p = 0, so dS = 0
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      sc[e] = exp2_ftz(sc[e] - lse2[i]) * (dp[e] - di[i]);
    }
  };
  // dq += dS k of tile kt (started, committed, not waited)
  auto start_dq = [&](int kt) {
    const uint32_t kb = sb + S::KV + (kt % S::NS) * S::STAGE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tile<D>(dqa, sa[kk], kb, 64, kk * 16);
    wgmma_commit();
  };
  auto fence_dq = [&]() {
#pragma unroll
    for (int ch = 0; ch < L::NCH; ++ch) fence_regs(dqa[ch]);
  };

  // The ring and the overlap are the forward's: tile kt's dS k is started
  // in iteration kt + 1 beside that iteration's two products; a stage is
  // refilled two iterations after its tile's products and one after its
  // dS k: four stages. Every warpgroup runs every tile.
  load_tile_async<D, DQ_BQ, DQ_NT>(sb, a.q + bh * Sq * D, q0, Sq, tid);
  load_tile_async<D, DQ_BQ, DQ_NT>(sb + S::DO, a.dout + bh * Sq * D, q0, Sq,
                                   tid);
  load_kv(0);
  cp_async_commit();
  if (last >= 1) {
    load_kv(1);
    cp_async_commit();
  }
  if (last >= 1) cp_async_wait<1>();
  else cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  if (last >= 2) {
    load_kv(2);
    cp_async_commit();
  }
  start_sdp(0);
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  grads(0);
  pack_a(sc, sa);
  for (int kt = 1; kt <= last; ++kt) {
    if (kt < last) cp_async_wait<1>();
    else cp_async_wait<0>();
    fence_proxy_async();
    // tile kt is visible; every warpgroup is past iteration kt - 1, so the
    // dS k of tile kt - 2 is done and its stage may be refilled
    __syncthreads();
    if (kt + 2 <= last) {
      load_kv(kt + 2);
      cp_async_commit();
    }
    fence_dq();
    start_sdp(kt);  // its wgmma_fence also covers sa and dqa
    start_dq(kt - 1);
    wgmma_wait<1>();
    fence_regs(sc);
    fence_regs(dp);
    grads(kt);
    wgmma_wait<0>();
    fence_dq();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(sa[kk]);
    pack_a(sc, sa);
  }
  fence_dq();
  wgmma_fence();
  start_dq(last);
  wgmma_wait<0>();
  fence_dq();
  __syncthreads();  // all of shared memory is free for the output

  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem) + wg * 64 * (D + 8);
  const float scale[2] = {a.sm_scale, a.sm_scale};
  if (live) stage_acc<D>(st, dqa, scale, t);
  __syncthreads();
  if (live) store_rows<D>(dq + bh * Sq * D, st, qw0, Sq, t);
}

template <int D>
int launch_dkv(const Args& a, int B, void* dk, void* dv, cudaStream_t st) {
  const size_t smem = DkvSmem<D>::BYTES + 1024;  // + alignment to 1024
  cudaError_t err =
      flash_sm90::allow_smem<flash_bwd_dkv_kernel<D>>((int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + 63) / 64, a.H, B);
  flash_bwd_dkv_kernel<D><<<grid, 128, smem, st>>>(
      a, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv);
  return (int)cudaGetLastError();
}

template <int D, bool kFullBias>
int launch_dq_variant(const Args& a, int B, void* dq, cudaStream_t st) {
  const size_t smem = DqSmem<D>::BYTES + 1024;  // + alignment to 1024
  cudaError_t err =
      flash_sm90::allow_smem<flash_bwd_dq_kernel<D, kFullBias>>((int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(flash_sm90::cdiv(a.Sq, DQ_BQ), a.H, B);
  flash_bwd_dq_kernel<D, kFullBias><<<grid, DQ_NT, smem, st>>>(
      a, (__nv_bfloat16*)dq);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Args& a, int B, void* dq, cudaStream_t st) {
  return a.bias != nullptr && a.bias_sq != 0
             ? launch_dq_variant<D, true>(a, B, dq, st)
             : launch_dq_variant<D, false>(a, B, dq, st);
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               long long bsb, long long bsh, long long bsq, const void* q_ids,
               const void* kv_ids, int ids_mode, const void* lse,
               const void* di, const void* dout, int H, int Sq, int Sk,
               int causal, float sm_scale, float mask_value) {
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.bias = (const float*)bias;
  a.bias_sb = bsb;
  a.bias_sh = bsh;
  a.bias_sq = bsq;
  a.q_ids = (const int*)q_ids;
  a.kv_ids = (const int*)kv_ids;
  a.ids_mode = ids_mode;
  a.lse = (const float*)lse;
  a.di = (const float*)di;
  a.dout = (const __nv_bfloat16*)dout;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.sm_scale = sm_scale;
  a.mask_value = mask_value;
  return a;
}

}  // namespace

extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* bias,
    long long bias_sb, long long bias_sh, long long bias_sq,
    const void* q_ids, const void* kv_ids, int ids_mode, const void* lse,
    const void* di, const void* dout, void* dk, void* dv, int B, int H,
    int Sq, int Sk, int D, int causal, float sm_scale, float mask_value,
    void* stream) {
  const Args a = make_args(q, k, v, bias, bias_sb, bias_sh, bias_sq, q_ids,
                           kv_ids, ids_mode, lse, di, dout, H, Sq, Sk, causal,
                           sm_scale, mask_value);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_dkv<16>(a, B, dk, dv, st);
    case 32: return launch_dkv<32>(a, B, dk, dv, st);
    case 48: return launch_dkv<48>(a, B, dk, dv, st);
    case 64: return launch_dkv<64>(a, B, dk, dv, st);
    case 80: return launch_dkv<80>(a, B, dk, dv, st);
    case 96: return launch_dkv<96>(a, B, dk, dv, st);
    case 112: return launch_dkv<112>(a, B, dk, dv, st);
    case 128: return launch_dkv<128>(a, B, dk, dv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* bias,
    long long bias_sb, long long bias_sh, long long bias_sq,
    const void* q_ids, const void* kv_ids, int ids_mode, const void* lse,
    const void* di, const void* dout, void* dq, int B, int H, int Sq, int Sk,
    int D, int causal, float sm_scale, float mask_value, void* stream) {
  const Args a = make_args(q, k, v, bias, bias_sb, bias_sh, bias_sq, q_ids,
                           kv_ids, ids_mode, lse, di, dout, H, Sq, Sk, causal,
                           sm_scale, mask_value);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_dq<16>(a, B, dq, st);
    case 32: return launch_dq<32>(a, B, dq, st);
    case 48: return launch_dq<48>(a, B, dq, st);
    case 64: return launch_dq<64>(a, B, dq, st);
    case 80: return launch_dq<80>(a, B, dq, st);
    case 96: return launch_dq<96>(a, B, dq, st);
    case 112: return launch_dq<112>(a, B, dq, st);
    case 128: return launch_dq<128>(a, B, dq, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
