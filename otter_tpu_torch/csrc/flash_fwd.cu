// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out + f32 LSE.
//
// Replaces the Pallas TPU kernel otter_tpu/ops/flash_attention.py:_fwd_kernel
// (launched from _fwd, entry point flash_attention). Same function:
//   q is pre-scaled by sm_scale*log2(e), rounded to bf16 (q's dtype);
//   s = q.k (f32) + bias*log2(e); s = mask ? s : mask_value, where the mask
//   is the id comparison (eq / ge) AND the causal condition col <= row;
//   base-2 online softmax with f32 statistics; p is rounded to bf16 before
//   p.v; out = acc / l (l == 0 -> 1); lse = ln2 * (m + log2 l), natural log.
//
// What bounds it on the H100: at the slice's shapes (S <= 320, D 64/128)
// the work is O(S^2 D) multiply-adds per (batch, head) on data that fits
// in shared memory, so it is bound by operations, not bytes. This first
// version runs them on the CUDA cores in f32 (no mma/wgmma yet): a tensor
// core path is the next step. The design keeps every tile in shared memory
// and the running max/sum/accumulator in registers, so the S x S logits
// never reach device memory.
//
// Design: one CTA of 256 threads per (64-query tile, head, batch). The
// sequential kv-grid axis and the m/l/acc VMEM scratch of the TPU kernel
// become a loop over 64-key tiles inside the CTA. For causal attention the
// loop stops at the tile holding the diagonal (the TPU's triangle grid).
// Thread (r, c) = (tid / 16, tid % 16) owns query rows 4r..4r+3 and, in the
// 64x64 logits tile, key columns c + 16j (j < 4); in the output it owns
// head-dim columns c + 16j (j < D/16). Row max and row sum reduce over the
// 16 lanes that share r. No padding of S or D is done: keys past S_k are
// excluded outright (p = 0), which is what the TPU path's PAD_ID ids did.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    long long bias_sb, long long bias_sh, long long bias_sq,
    const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
    int ids_mode, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int H, int Sq, int Sk, int causal, float q_scale, float mask_value) {
  constexpr int QS = D + 1;   // padded row strides: conflict-free reads
  constexpr int PS = BK + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QS]
  float* Ks = Qs + BQ * QS;     // [BK][QS]
  float* Vs = Ks + BK * QS;     // [BK][D]
  float* Ps = Vs + BK * D;      // [BQ][PS]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const long long bh = (long long)b * H + h;
  const __nv_bfloat16* qp = q + bh * Sq * D;
  const __nv_bfloat16* kp = k + bh * Sk * D;
  const __nv_bfloat16* vp = v + bh * Sk * D;
  const int q0 = qt * BQ;

  for (int e = tid; e < BQ * D; e += NT) {
    const int row = e / D, d = e % D;
    float x = 0.f;
    if (q0 + row < Sq)
      x = round_bf16(__bfloat162float(qp[(long long)(q0 + row) * D + d]) *
                     q_scale);
    Qs[row * QS + d] = x;
  }

  int qid[4];
  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    qid[i] = (ids_mode != 0 && row < Sq) ? q_ids[(long long)b * Sq + row] : 0;
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = (Sk + BK - 1) / BK;
  const int last = causal ? min(n_kv - 1, (q0 + BQ - 1) / BK) : n_kv - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int e = tid; e < BK * D; e += NT) {
      const int row = e / D, d = e % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + row < Sk) {
        const long long off = (long long)(k0 + row) * D + d;
        kx = __bfloat162float(kp[off]);
        vx = __bfloat162float(vp[off]);
      }
      Ks[row * QS + d] = kx;
      Vs[row * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(r * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(c + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r * 4 + i;
      const int brow = row < Sq ? row : Sq - 1;
      float p[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + c + 16 * j;
        float x = s[i][j];
        if (col >= Sk) {
          x = -INFINITY;
        } else {
          if (bias != nullptr)
            x += bias[b * bias_sb + h * bias_sh + brow * bias_sq + col] *
                 LOG2E;
          bool ok = true;
          if (ids_mode == 1) ok = qid[i] == kv_ids[(long long)b * Sk + col];
          else if (ids_mode == 2) ok = qid[i] >= kv_ids[(long long)b * Sk + col];
          if (causal) ok = ok && (col <= row);
          if (!ok) x = mask_value;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one key < Sk, so m_new is finite
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = exp2f(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = exp2f(s[i][j] - m_new);
        rs += p[j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(r * 4 + i) * PS + c + 16 * j] = round_bf16(p[j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(r * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= Sq) continue;
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];
    const float linv = 1.f / l;
    __nv_bfloat16* op = out + (bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      op[c + 16 * j] = __float2bfloat16(acc[i][j] * linv);
    if (c == 0) lse[bh * Sq + row] = LN2 * (m_i[i] + log2f(l));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           long long bsb, long long bsh, long long bsq, const void* q_ids,
           const void* kv_ids, int ids_mode, void* out, void* lse, int B,
           int H, int Sq, int Sk, int causal, float q_scale, float mask_value,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)bias, bsb, bsh, bsq,
      (const int*)q_ids, (const int*)kv_ids, ids_mode, (__nv_bfloat16*)out,
      (float*)lse, H, Sq, Sk, causal, q_scale, mask_value);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* bias, long long bias_sb,
                              long long bias_sh, long long bias_sq,
                              const void* q_ids, const void* kv_ids,
                              int ids_mode, void* out, void* lse, int B,
                              int H, int Sq, int Sk, int D, int causal,
                              float q_scale, float mask_value, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch<16>(q, k, v, bias, bias_sb, bias_sh, bias_sq, q_ids,
                        kv_ids, ids_mode, out, lse, B, H, Sq, Sk, causal,
                        q_scale, mask_value, st);
    case 32:
      return launch<32>(q, k, v, bias, bias_sb, bias_sh, bias_sq, q_ids,
                        kv_ids, ids_mode, out, lse, B, H, Sq, Sk, causal,
                        q_scale, mask_value, st);
    case 64:
      return launch<64>(q, k, v, bias, bias_sb, bias_sh, bias_sq, q_ids,
                        kv_ids, ids_mode, out, lse, B, H, Sq, Sk, causal,
                        q_scale, mask_value, st);
    case 128:
      return launch<128>(q, k, v, bias, bias_sb, bias_sh, bias_sq, q_ids,
                         kv_ids, ids_mode, out, lse, B, H, Sq, Sk, causal,
                         q_scale, mask_value, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* otter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
