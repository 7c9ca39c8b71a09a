// No-max flash attention forward for Hopper (sm_90a): the function of
// csrc/flash_attention.cu with the running row max replaced by a cap on the
// row's scores that is computed outside the kernel:
//   p = exp(q-hat.k^T + key_bias - cap),  l = sum_k p,  out = (p.v) / max(l, 1e-30),
//   lse = cap + log(max(l, 1e-30))
// where q-hat = q*scale rounded to bf16 and cap_i = |q-hat_i| * max_k |k_k| + 1
// (Cauchy-Schwarz plus a margin for rounding), both made by the wrapper in
// PyTorch from the very values the kernel multiplies.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fwd_kernel_nomax
// (launched from _flash_fwd_impl under the _NOMAX switch). Layouts: q-hat/k/v
// [B, S, H, D] bf16, contiguous; key_bias [B, Sk] f32 or NULL; cap [B*H, Sq]
// f32; out [B, Sq, H, D] bf16; lse [B*H, Sq] f32 (natural log).
//
// What bounds it: as the one-chain kernel, 4*D tensor-core flops and one
// exponential per score. What the cap buys on this card: p <= e^-1 whatever
// the tile, so nothing is ever rescaled: no running max, no max reduction
// across the warp, no second exponential per row and tile, and the output
// accumulators stay in registers (WMMA fragments) for the whole key loop
// where the one-chain kernel round-trips them through shared memory to scale
// them. The row sum is kept as per-lane partial sums and reduced once.
// A row whose scores all sit more than ~87 (the fp32 exponent range) below
// the cap underflows to p = 0 everywhere: l is clamped at 1e-30, so the row
// comes out as finite zeros, not 0/0.
// Design: one block per (b*h, 64-row q tile), four warps, each owning 16 query
// rows; K/V stream through shared memory in 64-key tiles; bf16 WMMA with fp32
// sums. D is padded to a multiple of 16 in shared memory only.
//
// EXP2 = true is the exp2 form (the JAX package's _EXP2 switch): the wrapper
// folds log2(e) into q-hat and hence into cap; the kernel folds it into the
// bias, takes exp2(s + bias - cap) with no multiply, and divides cap by
// log2(e) for the lse. The natural form multiplies (s + bias - cap) by
// log2(e) before the same ex2.approx.

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// width of a warp's fp32 area, which holds its scores, then its output rows
template <int DP>
__host__ __device__ constexpr int score_width() { return DP > BK ? DP : BK; }

template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * DP + 2 * BK * DP + BQ * BK) * sizeof(bf16) +
         (size_t)(BQ * score_width<DP>() + BQ) * sizeof(float);
}

template <int DP, bool EXP2>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_nomax_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ cap, bf16* __restrict__ out,
                       float* __restrict__ lse, int H, int Sq, int Sk, int D) {
  constexpr int SW = score_width<DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                       // [BQ][DP]
  bf16* Ks = Qs + BQ * DP;                                        // [BK][DP]
  bf16* Vs = Ks + BK * DP;                                        // [BK][DP]
  bf16* Ps = Vs + BK * DP;                                        // [BQ][BK]
  float* Ss = reinterpret_cast<float*>(Ps + BQ * BK);             // [NWARPS][16][SW]
  float* cap_s = Ss + BQ * SW;                                    // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rs = (long)H * D;                                    // elements per sequence position
  const bf16* qb = q + (long)b * Sq * rs + (long)h * D;
  const bf16* kb = k + (long)b * Sk * rs + (long)h * D;
  const bf16* vb = v + (long)b * Sk * rs + (long)h * D;
  const float* biasb = bias ? bias + (long)b * Sk : nullptr;
  const int chunks = D / 8;                                       // 16-byte chunks per row

  // zero Q/K/V tiles once: their pad columns [D, DP) then stay zero
  for (int i = tid; i < (BQ + 2 * BK) * DP; i += NTHREADS) Qs[i] = __float2bfloat16(0.f);
  for (int i = tid; i < BQ; i += NTHREADS)
    cap_s[i] = q0 + i < Sq ? cap[(long)bh * Sq + q0 + i] : 0.f;
  __syncthreads();
  for (int i = tid; i < BQ * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (long)(q0 + r) * rs + c);
    *reinterpret_cast<uint4*>(Qs + r * DP + c) = val;
  }

  const int row0 = warp * 16;                                     // this warp's query rows
  float* Sw = Ss + warp * 16 * SW;                                // this warp's scores [16][BK]
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo[DP / 16];
#pragma unroll
  for (int dj = 0; dj < DP / 16; ++dj) wmma::fill_fragment(fo[dj], 0.f);
  float lsum[16];                                                 // this lane's share of the row sums
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) lsum[rr] = 0.f;

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

    // scores S[row0:row0+16, 0:BK] = Q-hat K^T
    {
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
        wmma::store_matrix_sync(Sw + j * 16, acc[j], BK, wmma::mem_row_major);
    }
    __syncwarp();

    // one exponential pass, two keys per lane: no max, no rescale
    const int c0 = lane, c1 = lane + 32;
    const bool ok0 = k0 + c0 < Sk, ok1 = k0 + c1 < Sk;
    const float fold = EXP2 ? LOG2E : 1.f;
    const float bias0 = (biasb && ok0) ? biasb[k0 + c0] * fold : 0.f;
    const float bias1 = (biasb && ok1) ? biasb[k0 + c1] * fold : 0.f;
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const float off0 = bias0 - cap_s[row0 + rr], off1 = bias1 - cap_s[row0 + rr];
      const float e0 = Sw[rr * BK + c0] + off0, e1 = Sw[rr * BK + c1] + off1;
      const float p0 = ok0 ? exp2f(EXP2 ? e0 : e0 * LOG2E) : 0.f;
      const float p1 = ok1 ? exp2f(EXP2 ? e1 : e1 * LOG2E) : 0.f;
      lsum[rr] += p0 + p1;
      Ps[(row0 + rr) * BK + c0] = __float2bfloat16(p0);
      Ps[(row0 + rr) * BK + c1] = __float2bfloat16(p1);
    }
    __syncwarp();

    // O[row0:row0+16, :] += P V, accumulators in registers
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, Ps + row0 * BK + kk, BK);
#pragma unroll
      for (int dj = 0; dj < DP / 16; ++dj) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, Vs + kk * DP + dj * 16, DP);
        wmma::mma_sync(fo[dj], fp, fv, fo[dj]);
      }
    }
  }
  __syncwarp();

  // the warp's fp32 area now stages its output rows [16][DP]
#pragma unroll
  for (int dj = 0; dj < DP / 16; ++dj)
    wmma::store_matrix_sync(Sw + dj * 16, fo[dj], DP, wmma::mem_row_major);
  float l_mine = 1.f;                                             // lane rr keeps row rr's sum
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const float l = fmaxf(warp_sum(lsum[rr]), 1e-30f);            // underflow row: zeros, not NaN
    if (lane == rr) l_mine = l;
  }
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int rr = i / D, d = i % D;
    const float l = __shfl_sync(0xffffffffu, l_mine, rr);
    if (q0 + row0 + rr < Sq)
      out[((long)b * Sq + q0 + row0 + rr) * rs + (long)h * D + d] =
          __float2bfloat16(Sw[rr * DP + d] / l);
  }
  if (lane < 16) {
    const int r = row0 + lane;
    if (q0 + r < Sq)
      lse[(long)bh * Sq + q0 + r] = (EXP2 ? cap_s[r] / LOG2E : cap_s[r]) + logf(l_mine);
  }
}

template <int DP, bool EXP2>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* cap, void* out, void* lse, int B, int Sq, int Sk, int H, int D,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_nomax_kernel<DP, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_nomax_kernel<DP, EXP2><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(cap), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Sq, Sk, D);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. q is the
// pre-scaled q-hat and cap the row caps in the same domain (natural, or log2
// when exp2 != 0).
extern "C" int flash_attention_fwd_nomax(const void* q, const void* k, const void* v,
                                         const void* bias, const void* cap, void* out,
                                         void* lse, int B, int Sq, int Sk, int H, int D,
                                         int exp2, void* stream) {
  if (D % 8 != 0 || D <= 0 || D > 128 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_NOMAX_CASE(DP)                                                                  \
  case DP:                                                                                    \
    return (int)(exp2 ? launch<DP, true>(q, k, v, bias, cap, out, lse, B, Sq, Sk, H, D, s)    \
                      : launch<DP, false>(q, k, v, bias, cap, out, lse, B, Sq, Sk, H, D, s));
  switch ((D + 15) / 16 * 16) {
    FLASH_NOMAX_CASE(16)
    FLASH_NOMAX_CASE(32)
    FLASH_NOMAX_CASE(48)
    FLASH_NOMAX_CASE(64)
    FLASH_NOMAX_CASE(80)
    FLASH_NOMAX_CASE(96)
    FLASH_NOMAX_CASE(112)
    FLASH_NOMAX_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_NOMAX_CASE
}
