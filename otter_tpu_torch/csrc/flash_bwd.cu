// Flash-attention backward for Hopper (sm_90a): bf16 q/k/v/do in, f32 LSE
// and di in, bf16 dk/dv (one kernel) and dq (another) out.
//
// Replaces the Pallas TPU kernels otter_tpu/ops/flash_attention.py:
// _bwd_dkv_kernel and _bwd_dq_kernel (launched from _bwd through
// _bwd_pallas_call). Same function, per (q, k) pair:
//   s  = (q.k) * sm_scale + bias      (f32 products, q unscaled)
//   s  = mask ? s : mask_value        (ids eq/ge AND causal col <= row)
//   p  = exp(s - lse)                 (f32, never rounded to bf16)
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
// What bounds it on the H100: the backward does 4 (dK/dV) and 3 (dQ)
// products of [64 x 64 x D] per tile pair, O(S_q S_k D) work on tiles that
// sit in shared memory, so it is bound by operations, not bytes. This
// first version runs them on the CUDA cores in f32 (no mma/wgmma yet):
// tensor cores are the next step. The design keeps every tile in shared
// memory and the accumulators in registers, so neither the S_q x S_k
// probabilities nor their gradient reach device memory.
//
// Design. Blocks run in parallel in no order, so the TPU's sequential grid
// axis and its dk/dv/dq VMEM scratch become a loop inside one CTA of 256
// threads:
//   dK/dV: one CTA per (64-key tile, head, batch) walks the 64-query tiles,
//          starting at the diagonal tile when causal.
//   dQ:    one CTA per (64-query tile, head, batch) walks the 64-key tiles,
//          stopping at the diagonal tile when causal.
// In the 64 x 64 logits tile thread (r, c) = (tid / 16, tid % 16) owns
// query rows 4r..4r+3 and key columns c + 16j (j < 4). For the products
// into dk/dv it owns key rows 4r..4r+3 (into dq: query rows 4r..4r+3) and
// head-dim columns c + 16j (j < D/16). Row strides of D + 1 and 65 floats
// keep the shared-memory reads free of bank conflicts.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    Args a, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
  constexpr int QS = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][QS]
  float* Vs = Ks + BK * QS;    // [BK][QS]
  float* Qs = Vs + BK * QS;    // [BQ][QS]
  float* dOs = Qs + BQ * QS;   // [BQ][QS]
  float* Ps = dOs + BQ * QS;   // [BQ][PS]
  float* dSs = Ps + BQ * PS;   // [BQ][PS]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const long long bh = (long long)b * a.H + h;
  const int k0 = kt * BK;
  load_tile<D>(Ks, a.k + bh * a.Sk * D, k0, a.Sk);
  load_tile<D>(Vs, a.v + bh * a.Sk * D, k0, a.Sk);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = (a.Sq + BQ - 1) / BQ;
  // causal: query tiles before the one holding row k0 see none of these keys
  const int first = a.causal ? k0 / BQ : 0;
  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs are no longer read
    load_tile<D>(Qs, a.q + bh * a.Sq * D, q0, a.Sq);
    load_tile<D>(dOs, a.dout + bh * a.Sq * D, q0, a.Sq);
    Rows rw;
    load_rows(a, b, bh, q0, r, rw);
    __syncthreads();

    float p[4][4], ds[4][4];
    tile_grads<D>(a, b, h, q0, k0, r, c, rw, Qs, dOs, Ks, Vs, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(r * 4 + i) * PS + c + 16 * j] = p[i][j];
        dSs[(r * 4 + i) * PS + c + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // dv[key, d] += sum_q p[q, key] do[q, d]; dk[key, d] += ds[q, key] q[q, d]
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[4], sv[4], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[qq * PS + r * 4 + i];
        sv[i] = dSs[qq * PS + r * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = dOs[qq * QS + c + 16 * j];
        qv[j] = Qs[qq * QS + c + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + r * 4 + i;
    if (row >= a.Sk) continue;
    const long long off = (bh * a.Sk + row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + c + 16 * j] = __float2bfloat16(dk_acc[i][j]);
      dv[off + c + 16 * j] = __float2bfloat16(dv_acc[i][j]);
    }
  }
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
  const size_t smem =
      (size_t)(4 * 64 * (D + 1) + 2 * BQ * PS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + BK - 1) / BK, a.H, B);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, st>>>(
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
    case 64: return launch_dkv<64>(a, B, dk, dv, st);
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
    case 64: return launch_dq<64>(a, B, dq, st);
    case 128: return launch_dq<128>(a, B, dq, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
