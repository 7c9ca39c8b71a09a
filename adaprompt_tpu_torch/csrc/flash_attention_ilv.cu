// Two-chain flash attention forward for Hopper (sm_90a): the function of
// csrc/flash_attention.cu, out = softmax(q.k^T*scale + key_bias) . v plus the
// per-row natural-log logsumexp, computed as two independent online-softmax
// chains over alternating 64-key tiles that are merged exactly at the end.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fwd_kernel_ilv
// (launched from _flash_fwd_impl under the _ILV switch). Layouts as the
// one-chain kernel: q/k/v [B, S, H, D] bf16, contiguous; key_bias [B, Sk] f32
// or NULL; out [B, Sq, H, D] bf16; lse [B*H, Sq] f32.
//
// What bounds it: as the one-chain kernel, 4*D tensor-core flops and one
// exponential per score; at D=40 the exponentials and the shared-memory
// round trips of the scores bind, not the tensor cores. What the two chains
// are for: in one chain tile i+1's max, exponentials and rescale wait for
// tile i's; with two (m, l, acc) states a warp issues the score products of
// both tiles of a pair before either softmax update, and the two updates
// have no dependency on each other, so the scheduler may overlap one chain's
// tensor-core work with the other's exponentials.
// Design: one block per (b*h, 64-row q tile), four warps, each owning 16
// query rows and both chains of those rows for the whole kernel. A pair of
// key tiles is staged at once; chain 0 takes tiles 0, 2, 4, ..., chain 1
// tiles 1, 3, 5, .... Every tile count is right: with an odd count the last
// pair holds one tile and chain 1 sits that pair out; a chain that never got
// a tile keeps m = -inf, l = 0, acc = 0 and merges with weight
// exp2(-inf) = 0, without a NaN (chain 0 always has tile 0, so the joint max
// is finite). The merge is the online-softmax rescale applied once more:
// m = max(m0, m1), l = l0*2^(m0-m) + l1*2^(m1-m), acc likewise. Both chains'
// state doubles the shared memory of the one-chain kernel (97.5 KB a block
// at D=40, two blocks an SM), which is the price of the overlap.
//
// EXP2 = true is the exp2 form (the JAX package's _EXP2 switch): scale*log2(e)
// folded into the staged q tile, rounded to bf16, and log2(e) into the bias.

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

using bf16 = __nv_bfloat16;

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
  return (size_t)(BQ * DP + 4 * BK * DP + BQ * BK) * sizeof(bf16) +
         (size_t)(2 * BQ * BK + 2 * BQ * DP + 6 * BQ) * sizeof(float);
}

// Rows [r0, r0+64) of one head into a [64][DP] tile; rows past n are zero,
// columns [D, DP) are left as they are (zeroed once at the start).
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int n, long rs,
                                          int D, int tid) {
  const int chunks = D / 8;                       // 16-byte chunks per row
  for (int i = tid; i < BK * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
  }
}

// S[row0:row0+16, 0:BK] = Q K^T for this warp's rows
template <int DP>
__device__ __forceinline__ void score_tile(float* Ss, const bf16* Qs, const bf16* Ks, int row0) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, Qs + row0 * DP + kk, DP);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, Ks + j * 16 * DP + kk, DP);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wmma::store_matrix_sync(Ss + row0 * BK + j * 16, acc[j], BK, wmma::mem_row_major);
}

// One online-softmax step of one chain for this warp's 16 rows: the scores
// of the tile at k0 in Ss, the chain's state in (m_s, l_s, Os).
template <int DP, bool EXP2>
__device__ __forceinline__ void chain_update(const float* Ss, bf16* Ps, const bf16* Vs,
                                             float* Os, float* m_s, float* l_s, float* a_s,
                                             const float* biasb, int k0, int Sk,
                                             float scale_log2, int row0, int lane) {
  const int c0 = lane, c1 = lane + 32;            // two keys per lane
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
      const float alpha = exp2f(m_old - m_new);   // 0 on the chain's first tile (m_old = -inf)
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
#pragma unroll
  for (int dj = 0; dj < DP / 16; ++dj) {          // O[row0:row0+16, :] += P V
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo;
    wmma::load_matrix_sync(fo, Os + row0 * DP + dj * 16, DP, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
      wmma::load_matrix_sync(fp, Ps + row0 * BK + kk, BK);
      wmma::load_matrix_sync(fv, Vs + kk * DP + dj * 16, DP);
      wmma::mma_sync(fo, fp, fv, fo);
    }
    wmma::store_matrix_sync(Os + row0 * DP + dj * 16, fo, DP, wmma::mem_row_major);
  }
  __syncwarp();                                   // Ps is free for the other chain
}

template <int DP, bool EXP2>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_ilv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse,
                     int H, int Sq, int Sk, int D, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                       // [BQ][DP]
  bf16* Ks = Qs + BQ * DP;                                        // [2][BK][DP]
  bf16* Vs = Ks + 2 * BK * DP;                                    // [2][BK][DP]
  bf16* Ps = Vs + 2 * BK * DP;                                    // [BQ][BK]
  float* Ss = reinterpret_cast<float*>(Ps + BQ * BK);             // [2][BQ][BK]
  float* Os = Ss + 2 * BQ * BK;                                   // [2][BQ][DP]
  float* m_s = Os + 2 * BQ * DP;                                  // [2][BQ] running max (log2)
  float* l_s = m_s + 2 * BQ;                                      // [2][BQ] running sum
  float* a_s = l_s + 2 * BQ;                                      // [2][BQ] rescale / merge weight

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;                                    // elements per sequence position
  const bf16* qb = q + (long)b * Sq * rs + (long)h * D;
  const bf16* kb = k + (long)b * Sk * rs + (long)h * D;
  const bf16* vb = v + (long)b * Sk * rs + (long)h * D;
  const float* biasb = bias ? bias + (long)b * Sk : nullptr;
  const int chunks = D / 8;

  // zero Q/K/V tiles once: their pad columns [D, DP) then stay zero
  for (int i = tid; i < (BQ + 4 * BK) * DP; i += NTHREADS) Qs[i] = __float2bfloat16(0.f);
  for (int i = tid; i < 2 * BQ * DP; i += NTHREADS) Os[i] = 0.f;
  for (int i = tid; i < 2 * BQ; i += NTHREADS) { m_s[i] = -INFINITY; l_s[i] = 0.f; }
  __syncthreads();
  for (int i = tid; i < BQ * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (long)(q0 + r) * rs + c);
    if (EXP2) val = scale_bf16x8(val, scale_log2);                // q-hat: scores come out in log2
    *reinterpret_cast<uint4*>(Qs + r * DP + c) = val;
  }

  const int row0 = warp * 16;                                     // this warp's query rows
  for (int k0 = 0; k0 < Sk; k0 += 2 * BK) {
    const bool has_b = k0 + BK < Sk;                              // the pair's second tile exists
    __syncthreads();                                              // previous pair fully consumed
    load_tile<DP>(Ks, kb, k0, Sk, rs, D, tid);
    load_tile<DP>(Vs, vb, k0, Sk, rs, D, tid);
    if (has_b) {
      load_tile<DP>(Ks + BK * DP, kb, k0 + BK, Sk, rs, D, tid);
      load_tile<DP>(Vs + BK * DP, vb, k0 + BK, Sk, rs, D, tid);
    }
    __syncthreads();

    // both tiles' score products are issued before either chain's update
    score_tile<DP>(Ss, Qs, Ks, row0);
    if (has_b) score_tile<DP>(Ss + BQ * BK, Qs, Ks + BK * DP, row0);
    __syncwarp();
    chain_update<DP, EXP2>(Ss, Ps, Vs, Os, m_s, l_s, a_s, biasb, k0, Sk, scale_log2, row0, lane);
    if (has_b)
      chain_update<DP, EXP2>(Ss + BQ * BK, Ps, Vs + BK * DP, Os + BQ * DP, m_s + BQ, l_s + BQ,
                             a_s + BQ, biasb, k0 + BK, Sk, scale_log2, row0, lane);
  }
  __syncwarp();

  // merge the chains on their joint max
  if (lane < 16) {
    const int r = row0 + lane;
    const float m0 = m_s[r], m1 = m_s[BQ + r];
    const float m = fmaxf(m0, m1);                                // finite: chain 0 saw tile 0
    const float w0 = exp2f(m0 - m), w1 = exp2f(m1 - m);           // an empty chain: exp2(-inf) = 0
    const float l = l_s[r] * w0 + l_s[BQ + r] * w1;
    a_s[r] = w0;
    a_s[BQ + r] = w1;
    l_s[r] = l;
    if (q0 + r < Sq) lse[(long)bh * Sq + q0 + r] = m / LOG2E + logf(l);
  }
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = row0 + i / D, d = i % D;
    if (q0 + r < Sq) {
      const float o = Os[r * DP + d] * a_s[r] + Os[BQ * DP + r * DP + d] * a_s[BQ + r];
      out[((long)b * Sq + q0 + r) * rs + (long)h * D + d] = __float2bfloat16(o / l_s[r]);
    }
  }
}

template <int DP, bool EXP2>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* out, void* lse, int B, int Sq, int Sk, int H, int D,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_ilv_kernel<DP, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_ilv_kernel<DP, EXP2><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<float*>(lse),
      H, Sq, Sk, D, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. exp2 != 0
// selects the exp2 form.
extern "C" int flash_attention_fwd_ilv(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, void* lse,
                                       int B, int Sq, int Sk, int H, int D,
                                       float scale, int exp2, void* stream) {
  if (D % 8 != 0 || D <= 0 || D > 128 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ILV_CASE(DP)                                                                   \
  case DP:                                                                                   \
    return (int)(exp2 ? launch<DP, true>(q, k, v, bias, out, lse, B, Sq, Sk, H, D, scale, s) \
                      : launch<DP, false>(q, k, v, bias, out, lse, B, Sq, Sk, H, D, scale, s));
  switch ((D + 15) / 16 * 16) {
    FLASH_ILV_CASE(16)
    FLASH_ILV_CASE(32)
    FLASH_ILV_CASE(48)
    FLASH_ILV_CASE(64)
    FLASH_ILV_CASE(80)
    FLASH_ILV_CASE(96)
    FLASH_ILV_CASE(112)
    FLASH_ILV_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ILV_CASE
}
