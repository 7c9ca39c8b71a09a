// Flash attention forward for Hopper (sm_90a): out = softmax(q.k^T*scale +
// key_bias) . v with an fp32 online softmax, plus the per-row logsumexp.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fwd_kernel
// (launched from _flash_fwd_impl). Layouts are the JAX package's:
// q/k/v [B, S, H, D] bf16, contiguous; key_bias [B, Sk] f32 or NULL;
// out [B, Sq, H, D] bf16; lse [B*H, Sq] f32 (natural log).
//
// What bounds it: each score costs 4*D tensor-core flops (QK^T and PV) and
// one exponential. At the UNet's D=40 that is 160 flops, ~0.04 SM cycles at
// the H100's ~4096 dense bf16 flop/cycle/SM, against 1/16 SM cycle for the
// exponential at 16/cycle/SM: the exponentials bind, not the tensor cores.
// Bytes are small (q/k/v/out once each; K/V are re-read from L2 by every
// q tile).
// Design: one block per (b*h, 64-row q tile), four warps, each owning 16
// query rows for the whole kernel, so the softmax of a row needs only warp
// shuffles. K/V stream through shared memory in 64-key tiles; scores go
// through bf16 WMMA tiles with fp32 accumulation; the exponent is exp2
// with log2(e) folded into the score scale (one multiply-add per score).
// D is padded to a multiple of 16 (40 -> 48) in shared memory only: the
// pad columns are zero-filled there, never in device memory. This is a
// first, simple kernel: wgmma/TMA and register-resident accumulators are
// later work.
//
// The exp2 form (EXP2 = true; the JAX package's _EXP2 switch on _fwd_kernel):
// scale*log2(e) is folded into the q tile as it is staged, rounded to bf16
// there as the TPU kernel rounds its q tile, so a score leaves the tensor
// cores already in the log2 domain and needs an add of the folded bias
// where the natural form spends a multiply-add. Both forms end in
// ex2.approx (exp2f) and both write the natural-log lse. The rounding of the
// folded q makes the two forms differ in the last bf16 digits of the scores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// eight bf16 values times f, each rounded to bf16 again
__device__ __forceinline__ uint4 scale_bf16x8(uint4 v, float f) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    p[i] = __floats2bfloat162_rn(x.x * f, x.y * f);
  }
  return v;
}

template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * DP + 2 * BK * DP + BQ * BK) * sizeof(__nv_bfloat16) +
         (size_t)(BQ * BK + BQ * DP + 3 * BQ) * sizeof(float);
}

template <int DP, bool EXP2>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int H, int Sq, int Sk, int D, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [BQ][DP]
  __nv_bfloat16* Ks = Qs + BQ * DP;                               // [BK][DP]
  __nv_bfloat16* Vs = Ks + BK * DP;                               // [BK][DP]
  __nv_bfloat16* Ps = Vs + BK * DP;                               // [BQ][BK]
  float* Ss = reinterpret_cast<float*>(Ps + BQ * BK);             // [BQ][BK]
  float* Os = Ss + BQ * BK;                                       // [BQ][DP]
  float* m_s = Os + BQ * DP;                                      // [BQ] running max (log2 domain)
  float* l_s = m_s + BQ;                                          // [BQ] running sum
  float* a_s = l_s + BQ;                                          // [BQ] rescale factor

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;                                    // elements per sequence position
  const __nv_bfloat16* qb = q + (long)b * Sq * rs + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * Sk * rs + (long)h * D;
  const __nv_bfloat16* vb = v + (long)b * Sk * rs + (long)h * D;
  const float* biasb = bias ? bias + (long)b * Sk : nullptr;
  const int chunks = D / 8;                                       // 16-byte chunks per row

  // zero Q/K/V tiles once: their pad columns [D, DP) then stay zero
  for (int i = tid; i < (BQ + 2 * BK) * DP; i += NTHREADS) Qs[i] = __float2bfloat16(0.f);
  for (int i = tid; i < BQ * DP; i += NTHREADS) Os[i] = 0.f;
  for (int i = tid; i < BQ; i += NTHREADS) { m_s[i] = -INFINITY; l_s[i] = 0.f; }
  __syncthreads();
  for (int i = tid; i < BQ * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (long)(q0 + r) * rs + c);
    if (EXP2) val = scale_bf16x8(val, scale_log2);             // q-hat: scores come out in log2
    *reinterpret_cast<uint4*>(Qs + r * DP + c) = val;
  }

  const int row0 = warp * 16;                                     // this warp's query rows
  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();                                              // previous tile fully consumed
    for (int i = tid; i < BK * chunks; i += NTHREADS) {
      const int r = i / chunks, c = (i % chunks) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (long)(k0 + r) * rs + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long)(k0 + r) * rs + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * DP + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * DP + c) = vv;
    }
    __syncthreads();

    // scores S[row0:row0+16, 0:BK] = Q K^T
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Qs + row0 * DP + kk, DP);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Ks + j * 16 * DP + kk, DP);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(Ss + row0 * BK + j * 16, acc[j], BK, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, one row at a time, two keys per lane
    const int c0 = lane, c1 = lane + 32;
    const bool ok0 = k0 + c0 < Sk, ok1 = k0 + c1 < Sk;
    const float bias0 = (biasb && ok0) ? biasb[k0 + c0] * LOG2E : 0.f;
    const float bias1 = (biasb && ok1) ? biasb[k0 + c1] * LOG2E : 0.f;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const float x0 = Ss[r * BK + c0], x1 = Ss[r * BK + c1];
      const float s0 = ok0 ? (EXP2 ? x0 + bias0 : x0 * scale_log2 + bias0) : -INFINITY;
      const float s1 = ok1 ? (EXP2 ? x1 + bias1 : x1 * scale_log2 + bias1) : -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      Ps[r * BK + c0] = __float2bfloat16(p0);
      Ps[r * BK + c1] = __float2bfloat16(p1);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = row0 + i / DP;
      Os[r * DP + i % DP] *= a_s[r];
    }
    __syncwarp();

    // O[row0:row0+16, :] += P V
#pragma unroll
    for (int dj = 0; dj < DP / 16; ++dj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo;
      wmma::load_matrix_sync(fo, Os + row0 * DP + dj * 16, DP, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
        wmma::load_matrix_sync(fp, Ps + row0 * BK + kk, BK);
        wmma::load_matrix_sync(fv, Vs + kk * DP + dj * 16, DP);
        wmma::mma_sync(fo, fp, fv, fo);
      }
      wmma::store_matrix_sync(Os + row0 * DP + dj * 16, fo, DP, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = row0 + i / D, d = i % D;
    if (q0 + r < Sq)
      out[((long)b * Sq + q0 + r) * rs + (long)h * D + d] = __float2bfloat16(Os[r * DP + d] / l_s[r]);
  }
  if (lane < 16) {
    const int r = row0 + lane;
    if (q0 + r < Sq) lse[(long)bh * Sq + q0 + r] = m_s[r] / LOG2E + logf(l_s[r]);
  }
}

template <int DP, bool EXP2>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* out, void* lse, int B, int Sq, int Sk, int H, int D,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<DP, EXP2><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, Sq, Sk, D,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. exp2 != 0
// selects the exp2 form.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, void* lse,
                                   int B, int Sq, int Sk, int H, int D,
                                   float scale, int exp2, void* stream) {
  if (D % 8 != 0 || D <= 0 || D > 128 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_CASE(DP)                                                                   \
  case DP:                                                                                   \
    return (int)(exp2 ? launch<DP, true>(q, k, v, bias, out, lse, B, Sq, Sk, H, D, scale, s) \
                      : launch<DP, false>(q, k, v, bias, out, lse, B, Sq, Sk, H, D, scale, s));
  switch ((D + 15) / 16 * 16) {
    FLASH_FWD_CASE(16)
    FLASH_FWD_CASE(32)
    FLASH_FWD_CASE(48)
    FLASH_FWD_CASE(64)
    FLASH_FWD_CASE(80)
    FLASH_FWD_CASE(96)
    FLASH_FWD_CASE(112)
    FLASH_FWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_FWD_CASE
}
