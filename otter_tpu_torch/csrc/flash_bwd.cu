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
// dQ still runs on the CUDA cores in f32: one CTA of 256 threads per
// (64-query tile, head, batch) walks the 64-key tiles, stopping at the
// diagonal tile when causal. In the 64 x 64 logits tile thread (r, c) =
// (tid / 16, tid % 16) owns query rows 4r..4r+3 and key columns c + 16j
// (j < 4); for the product into dq it owns query rows 4r..4r+3 and
// head-dim columns c + 16j (j < D/16). Row strides of D + 1 and 65 floats
// keep the shared-memory reads free of bank conflicts.
#include "flash_sm90.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int PS = BK + 1;

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

// rows [row0, row0 + 64) of a [n, D] bf16 matrix into f32 shared memory
// with row stride D + 1; rows past n read as 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int row = e / D, d = e % D;
    dst[row * (D + 1) + d] =
        row0 + row < n ? __bfloat162float(src[(long long)(row0 + row) * D + d])
                       : 0.f;
  }
}

// The statistics of one thread's four query rows.
struct Rows {
  float lse[4], di[4];
  int qid[4];
  bool dead[4];
};

__device__ __forceinline__ void load_rows(const Args& a, int b, long long bh,
                                          int q0, int r, Rows& rw) {
  const float dead_below = 0.5f * a.mask_value;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    const bool ok = row < a.Sq;
    rw.lse[i] = ok ? a.lse[bh * a.Sq + row] : 0.f;
    rw.di[i] = ok ? a.di[bh * a.Sq + row] : 0.f;
    rw.qid[i] = (a.ids_mode != 0 && ok) ? a.q_ids[(long long)b * a.Sq + row]
                                         : 0;
    rw.dead[i] = ok && rw.lse[i] < dead_below;
  }
}

// p and ds of the thread's 4 x 4 pairs of the tile at (q0, k0), from the
// shared tiles Qs, dOs (query rows) and Ks, Vs (key rows).
template <int D>
__device__ __forceinline__ void tile_grads(const Args& a, int b, int h,
                                           int q0, int k0, int r, int c,
                                           const Rows& rw, const float* Qs,
                                           const float* dOs, const float* Ks,
                                           const float* Vs, float p[4][4],
                                           float ds[4][4]) {
  constexpr int QS = D + 1;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(r * 4 + i) * QS + d];
      ov[i] = dOs[(r * 4 + i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(c + 16 * j) * QS + d];
      vv[j] = Vs[(c + 16 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
  const float inv_sk = 1.f / (float)a.Sk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + c + 16 * j;
      float pij = 0.f, dsij = 0.f;
      if (row < a.Sq && col < a.Sk) {
        float x = s[i][j] * a.sm_scale;
        if (a.bias != nullptr)
          x += a.bias[b * a.bias_sb + h * a.bias_sh + row * a.bias_sq + col];
        bool ok = true;
        if (a.ids_mode == 1)
          ok = rw.qid[i] == a.kv_ids[(long long)b * a.Sk + col];
        else if (a.ids_mode == 2)
          ok = rw.qid[i] >= a.kv_ids[(long long)b * a.Sk + col];
        if (a.causal) ok = ok && (col <= row);
        if (ok) {
          pij = expf(x - rw.lse[i]);
          dsij = pij * (dp[i][j] - rw.di[i]) * a.sm_scale;
        } else if (rw.dead[i]) {
          pij = inv_sk;  // the forward averaged v over the real keys
        }
      }
      p[i][j] = pij;
      ds[i][j] = dsij;
    }
  }
}

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

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    Args a, __nv_bfloat16* __restrict__ dq) {
  constexpr int QS = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][QS]
  float* dOs = Qs + BQ * QS;   // [BQ][QS]
  float* Ks = dOs + BQ * QS;   // [BK][QS]
  float* Vs = Ks + BK * QS;    // [BK][QS]
  float* dSs = Vs + BK * QS;   // [BQ][PS]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const long long bh = (long long)b * a.H + h;
  const int q0 = qt * BQ;
  load_tile<D>(Qs, a.q + bh * a.Sq * D, q0, a.Sq);
  load_tile<D>(dOs, a.dout + bh * a.Sq * D, q0, a.Sq);
  Rows rw;
  load_rows(a, b, bh, q0, r, rw);

  float dq_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq_acc[i][j] = 0.f;

  const int n_kv = (a.Sk + BK - 1) / BK;
  const int last = a.causal ? min(n_kv - 1, (q0 + BQ - 1) / BK) : n_kv - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/dSs are no longer read
    load_tile<D>(Ks, a.k + bh * a.Sk * D, k0, a.Sk);
    load_tile<D>(Vs, a.v + bh * a.Sk * D, k0, a.Sk);
    __syncthreads();

    float p[4][4], ds[4][4];
    tile_grads<D>(a, b, h, q0, k0, r, c, rw, Qs, dOs, Ks, Vs, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(r * 4 + i) * PS + c + 16 * j] = ds[i][j];
    __syncthreads();

    // dq[q, d] += sum_key ds[q, key] k[key, d]
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(r * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * QS + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq_acc[i][j] = fmaf(sv[i], kv[j], dq_acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= a.Sq) continue;
    const long long off = (bh * a.Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[off + c + 16 * j] = __float2bfloat16(dq_acc[i][j]);
  }
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

template <int D>
int launch_dq(const Args& a, int B, void* dq, cudaStream_t st) {
  const size_t smem = (size_t)(4 * 64 * (D + 1) + BQ * PS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, st>>>(a, (__nv_bfloat16*)dq);
  return (int)cudaGetLastError();
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
