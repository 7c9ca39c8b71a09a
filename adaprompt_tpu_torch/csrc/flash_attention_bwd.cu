// Flash attention backward for Hopper (sm_90a): the FlashAttention-2
// recomputation backward from the forward's logsumexp.
//
//   p  = exp(q.k^T*scale + key_bias - lse)      (recomputed, never stored)
//   dV = p^T . dO
//   dS = p * (dO.v^T - delta),  delta = rowsum(dO * O)  (from the wrapper)
//   dQ = dS . k * scale
//   dK = dS^T . q * scale
//
// Replaces the TPU kernels adaprompt_tpu/ops/attention.py::_dq_kernel and
// ::_dkv_kernel (launched from _flash_bwd_impl). Layouts are the JAX
// package's: q/k/v/dO [B, S, H, D] bf16, contiguous; key_bias [B, Sk] f32 or
// NULL; lse and delta [B*H, Sq] f32 (natural log); dq/dk/dv [B, S, H, D] bf16.
//
// The JAX split is kept: one kernel gridded over q tiles writes dQ, one
// gridded over key tiles writes dK and dV, each recomputing p. No atomics,
// so the result is the same from run to run. P and dS are rounded to bf16
// before their products, as the Pallas kernels do; every sum is fp32.
//
// What bounds it: the work is 5 products of S^2*D per head (QK^T, dO.V^T,
// dS.K, P^T.dO, dS^T.Q) and one exponential per score; this split runs 7
// products and 2 exponentials per score, since both kernels recompute QK^T,
// dO.V^T and p. Bytes are small. At the UNet's D=40 the exponentials and
// the shared-memory round trips of the scores bind, not the tensor cores.
// Design, first and simple: four warps a block, each owning 16 rows of the
// block's 64-row tile for the whole kernel; WMMA bf16 tiles with fp32
// accumulators that stay in registers across the streamed loop; scores go
// through shared memory for the elementwise step. D is padded to a
// multiple of 16 (40 -> 48) in shared memory only: the pad columns are
// zero-filled there, never in device memory. wgmma/TMA are later work.
//
// The exp2 form (EXP2 = true; the JAX package's _EXP2 switch on both
// kernels): scale*log2(e) is folded into the q tile as it is staged (rounded
// to bf16, as the TPU kernels round it) and log2(e) into the staged bias and
// lse, so p = exp2(s + bias - lse) needs no multiply per score. dQ = dS.k
// keeps its factor of scale; dK = dS^T.q-hat already carries scale*log2(e)
// and is divided by log2(e) at the end. lse arrives in natural log either way.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Copy rows [r0, r0+64) of one head (row stride rs elements) into a
// [64][DP] shared tile; rows past `n` and columns past D stay zero.
// With SCALED, every value is multiplied by `mul` and rounded to bf16 again.
template <int DP, bool SCALED = false>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int n, long rs,
                                          int D, int tid, float mul = 1.f) {
  const int chunks = D / 8;                       // 16-byte chunks per row
  for (int i = tid; i < 64 * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * rs + c);
    if (SCALED) {
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(p[j]);
        p[j] = __floats2bfloat162_rn(x.x * mul, x.y * mul);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
  }
}

// out[16 x 64] (fp32, row stride 64) = A[16 x DP] . B^T where B is a [64][DP]
// tile: the scores of this warp's 16 rows against the 64 rows of B.
template <int DP>
__device__ __forceinline__ void rows_dot_tile(float* out, const bf16* a, const bf16* b) {
  FragC acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, DP);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBc fb;
      wmma::load_matrix_sync(fb, b + j * 16 * DP + kk, DP);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(out + j * 16, acc[j], 64, wmma::mem_row_major);
}

// acc[DP/16] += A[16 x 64] (bf16, row stride 64) . B[64][DP]
template <int DP>
__device__ __forceinline__ void accumulate(FragC* acc, const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, 64);
#pragma unroll
    for (int dj = 0; dj < DP / 16; ++dj) {
      FragBr fb;
      wmma::load_matrix_sync(fb, b + kk * DP + dj * 16, DP);
      wmma::mma_sync(acc[dj], fa, fb, acc[dj]);
    }
  }
}

// Write a warp's 16 x D result (acc * mul) as bf16 rows of one head, through
// a [16][DP] fp32 staging area of shared memory.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst, FragC* acc, float* stage, int r0, int n,
                                           long rs, int D, float mul, int lane) {
#pragma unroll
  for (int dj = 0; dj < DP / 16; ++dj) wmma::store_matrix_sync(stage + dj * 16, acc[dj], DP, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, d = i % D;
    if (r0 + r < n) dst[(long)(r0 + r) * rs + d] = __float2bfloat16(stage[r * DP + d] * mul);
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return (size_t)(4 * 64 * DP + 64 * 64) * sizeof(bf16) + (size_t)(2 * 64 * 64 + 2 * 64 + 64) * sizeof(float);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(4 * 64 * DP + 2 * 64 * 64) * sizeof(bf16) + (size_t)(2 * 64 * 64 + 2 * 64 + 64) * sizeof(float);
}

// dQ: one block per (b*h, 64-row q tile); streams every key tile.
template <int DP, bool EXP2>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int Sq, int Sk, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);       // [BQ][DP]
  bf16* dOs = Qs + BQ * DP;                       // [BQ][DP]
  bf16* Ks = dOs + BQ * DP;                       // [BK][DP]
  bf16* Vs = Ks + BK * DP;                        // [BK][DP]
  bf16* dSs = Vs + BK * DP;                       // [BQ][BK]
  float* Ss = reinterpret_cast<float*>(dSs + BQ * BK);  // [BQ][BK]
  float* dPs = Ss + BQ * BK;                      // [BQ][BK]
  float* lse_s = dPs + BQ * BK;                   // [BQ]
  float* dl_s = lse_s + BQ;                       // [BQ]
  float* bias_s = dl_s + BQ;                      // [BK]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;
  const long qoff = (long)b * Sq * rs + (long)h * D, koff = (long)b * Sk * rs + (long)h * D;

  for (int i = tid; i < 4 * 64 * DP; i += NTHREADS) Qs[i] = __float2bfloat16(0.f);
  for (int i = tid; i < BQ; i += NTHREADS) {
    const bool ok = q0 + i < Sq;
    // rows past Sq: exp(s - inf) = 0
    lse_s[i] = ok ? lse[(long)bh * Sq + q0 + i] * (EXP2 ? LOG2E : 1.f) : INFINITY;
    dl_s[i] = ok ? delta[(long)bh * Sq + q0 + i] : 0.f;
  }
  __syncthreads();
  load_tile<DP, EXP2>(Qs, q + qoff, q0, Sq, rs, D, tid, scale * LOG2E);
  load_tile<DP>(dOs, dout + qoff, q0, Sq, rs, D, tid);

  const int row0 = warp * 16;
  FragC acc[DP / 16];
#pragma unroll
  for (int dj = 0; dj < DP / 16; ++dj) wmma::fill_fragment(acc[dj], 0.f);

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();                              // previous K/V tile consumed
    load_tile<DP>(Ks, k + koff, k0, Sk, rs, D, tid);
    load_tile<DP>(Vs, v + koff, k0, Sk, rs, D, tid);
    for (int i = tid; i < BK; i += NTHREADS)
      bias_s[i] = (bias && k0 + i < Sk) ? bias[(long)b * Sk + k0 + i] * (EXP2 ? LOG2E : 1.f) : 0.f;
    __syncthreads();

    rows_dot_tile<DP>(Ss + row0 * BK, Qs + row0 * DP, Ks);    // S  = Q K^T
    rows_dot_tile<DP>(dPs + row0 * BK, dOs + row0 * DP, Vs);  // dP = dO V^T
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float p = 0.f;
        if (k0 + c < Sk)
          p = EXP2 ? exp2f(Ss[r * BK + c] + bias_s[c] - lse_s[r])
                   : exp2f((Ss[r * BK + c] * scale + bias_s[c] - lse_s[r]) * LOG2E);
        dSs[r * BK + c] = __float2bfloat16(p * (dPs[r * BK + c] - dl_s[r]));
      }
    }
    __syncwarp();
    accumulate<DP>(acc, dSs + row0 * BK, Ks);                 // dQ += dS K
  }
  __syncthreads();                                // Ss/dPs become the staging area
  store_rows<DP>(dq + qoff, acc, Ss + row0 * DP, q0 + row0, Sq, rs, D, scale, lane);
}

// dK, dV: one block per (b*h, 64-key tile); streams every q tile.
template <int DP, bool EXP2>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Sk, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);       // [BK][DP]
  bf16* Vs = Ks + BK * DP;                        // [BK][DP]
  bf16* Qs = Vs + BK * DP;                        // [BQ][DP]
  bf16* dOs = Qs + BQ * DP;                       // [BQ][DP]
  bf16* Ps = dOs + BQ * DP;                       // [BK][BQ]  P^T
  bf16* dSs = Ps + BK * BQ;                       // [BK][BQ]  dS^T
  float* Ss = reinterpret_cast<float*>(dSs + BK * BQ);  // [BK][BQ]
  float* dPs = Ss + BK * BQ;                      // [BK][BQ]
  float* lse_s = dPs + BK * BQ;                   // [BQ]
  float* dl_s = lse_s + BQ;                       // [BQ]
  float* bias_s = dl_s + BQ;                      // [BK]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;
  const long qoff = (long)b * Sq * rs + (long)h * D, koff = (long)b * Sk * rs + (long)h * D;

  for (int i = tid; i < 4 * 64 * DP; i += NTHREADS) Ks[i] = __float2bfloat16(0.f);
  for (int i = tid; i < BK; i += NTHREADS)
    bias_s[i] = (bias && k0 + i < Sk) ? bias[(long)b * Sk + k0 + i] * (EXP2 ? LOG2E : 1.f) : 0.f;
  __syncthreads();
  load_tile<DP>(Ks, k + koff, k0, Sk, rs, D, tid);
  load_tile<DP>(Vs, v + koff, k0, Sk, rs, D, tid);

  const int row0 = warp * 16;                     // this warp's keys
  FragC acc_dk[DP / 16], acc_dv[DP / 16];
#pragma unroll
  for (int dj = 0; dj < DP / 16; ++dj) {
    wmma::fill_fragment(acc_dk[dj], 0.f);
    wmma::fill_fragment(acc_dv[dj], 0.f);
  }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();                              // previous Q/dO tile consumed
    load_tile<DP, EXP2>(Qs, q + qoff, q0, Sq, rs, D, tid, scale * LOG2E);
    load_tile<DP>(dOs, dout + qoff, q0, Sq, rs, D, tid);
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool ok = q0 + i < Sq;
      lse_s[i] = ok ? lse[(long)bh * Sq + q0 + i] * (EXP2 ? LOG2E : 1.f) : INFINITY;
      dl_s[i] = ok ? delta[(long)bh * Sq + q0 + i] : 0.f;
    }
    __syncthreads();

    rows_dot_tile<DP>(Ss + row0 * BQ, Ks + row0 * DP, Qs);    // S^T  = K Q^T
    rows_dot_tile<DP>(dPs + row0 * BQ, Vs + row0 * DP, dOs);  // dP^T = V dO^T
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const float p = EXP2 ? exp2f(Ss[r * BQ + c] + bias_s[r] - lse_s[c])
                             : exp2f((Ss[r * BQ + c] * scale + bias_s[r] - lse_s[c]) * LOG2E);
        Ps[r * BQ + c] = __float2bfloat16(p);
        dSs[r * BQ + c] = __float2bfloat16(p * (dPs[r * BQ + c] - dl_s[c]));
      }
    }
    __syncwarp();
    accumulate<DP>(acc_dv, Ps + row0 * BQ, dOs);              // dV += P^T dO
    accumulate<DP>(acc_dk, dSs + row0 * BQ, Qs);              // dK += dS^T Q
  }
  __syncthreads();
  // under EXP2 the q-hat rows already carried scale*log2(e)
  store_rows<DP>(dk + koff, acc_dk, Ss + row0 * DP, k0 + row0, Sk, rs, D,
                 EXP2 ? 1.f / LOG2E : scale, lane);
  __syncwarp();
  store_rows<DP>(dv + koff, acc_dv, Ss + row0 * DP, k0 + row0, Sk, rs, D, 1.f, lane);
}

template <int DP, bool EXP2>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                   void* dv, int B, int Sq, int Sk, int H, int D, float scale, cudaStream_t stream) {
  const size_t s_dq = dq_smem_bytes<DP>(), s_dkv = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP, EXP2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_dkv);
  if (err != cudaSuccess) return err;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* bp = static_cast<const float*>(bias);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  flash_bwd_dq_kernel<DP, EXP2><<<dim3((Sq + BQ - 1) / BQ, B * H), NTHREADS, s_dq, stream>>>(
      qp, kp, vp, bp, dop, lp, dlp, static_cast<bf16*>(dq), H, Sq, Sk, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DP, EXP2><<<dim3((Sk + BK - 1) / BK, B * H), NTHREADS, s_dkv, stream>>>(
      qp, kp, vp, bp, dop, lp, dlp, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      H, Sq, Sk, D, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when both launches were accepted. exp2 != 0
// selects the exp2 form.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* dout, const void* lse,
                                   const void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int D, float scale,
                                   int exp2, void* stream) {
  if (D % 8 != 0 || D <= 0 || D > 128 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(DP)                                                                     \
  case DP:                                                                                     \
    return (int)(exp2 ? launch<DP, true>(q, k, v, bias, dout, lse, delta, dq, dk, dv, B, Sq,   \
                                         Sk, H, D, scale, s)                                   \
                      : launch<DP, false>(q, k, v, bias, dout, lse, delta, dq, dk, dv, B, Sq,  \
                                          Sk, H, D, scale, s));
  switch ((D + 15) / 16 * 16) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(48)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(80)
    FLASH_BWD_CASE(96)
    FLASH_BWD_CASE(112)
    FLASH_BWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}
