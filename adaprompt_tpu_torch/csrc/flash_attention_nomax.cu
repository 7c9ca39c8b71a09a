// No-max flash attention forward for Hopper (sm_90a): the function of
// csrc/flash_attention.cu with the running row max replaced by a cap on the
// row's scores:
//   p = exp(q-hat.k^T + key_bias - cap),  l = sum_k p,  out = (p.v) / max(l, 1e-30),
//   lse = cap + log(max(l, 1e-30))
// where q-hat = q*scale rounded to bf16 and cap_i = |q-hat_i| * kmax + 1,
// kmax = max_k |k_k| of the (batch, head) (Cauchy-Schwarz plus a margin for
// rounding). The kernel takes q and forms q-hat and |q-hat_i| itself as it
// stages the q tile, so the cap is built from the very values it multiplies;
// kmax comes from a pre-pass over K launched by the same call (one block per
// batch and head, ~10 MB read at the UNet's 4096 tokens; its plain version is
// ops/attention.py::nomax_key_max). Made by the wrapper in PyTorch, kmax took
// two to three eager launches and the host time to issue them on every call;
// made inside the attention kernel, it would re-read all of K for every q
// tile.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fwd_kernel_nomax
// (launched from _flash_fwd_impl under the _NOMAX switch). Layouts:
// q/k/v [B, S, H, D] bf16, contiguous; key_bias [B, Sk] f32 or NULL; kmax
// [B*H] f32; out [B, Sq, H, D] bf16; lse [B*H, Sq] f32 (natural log). D is a
// multiple of 8, at most 128; Sq and Sk are any lengths, equal or not.
//
// What bounds it: as the one-chain kernel, 4*D tensor-core flops and one
// exponential per score; at D=40 the exponentials bind. What the cap buys:
// p <= e^-1 whatever the tile, so nothing is ever rescaled: no running max,
// no max shuffles across the quad, no second exponential per row and tile,
// no O rescale. A score costs one multiply-add and one ex2.approx (two
// multiply-adds with a key bias).
//
// Design: the one-chain kernel's (csrc/flash_attention.cu, on the tile steps
// of csrc/flash_sm90.cuh): one block of four warps per (b*h, q tile), 128
// query rows for D <= 80 (32 a warp: two m16 tiles), 64 above; for D <= 48
// registers capped at 168, so that three blocks share an SM (with no row
// max the kernel needs fewer; on the H100 the cap won at D=40 S=4096 and
// lost at D=80, where it spills); Q's A
// fragments loaded once by ldmatrix and kept in registers; S = Q.K^T by
// mma.m16n8k16 into registers, D padded to 16 for that product only; P
// rounded to bf16 straight from the score registers as the A fragments of
// O += P.V, V by ldmatrix.trans in n8 steps; O in fp32 registers; K/V tiles
// of 64 keys and their key bias through a ring of cp.async stages (three for
// D <= 64, two above) with 16-byte-padded rows; the epilogue stages O/l in
// the warp's own rows of the Q tile and stores 16 bytes a lane. l is a
// per-thread partial, reduced over the quad once at the end and clamped at
// 1e-30: a row whose scores all sit more than ~87 (the fp32 exponent range)
// below the cap underflows to p = 0 everywhere and comes out as
// finite zeros, not 0/0.
// |q-hat_i|: after the q tile is staged (q times scale, or scale*log2(e) in
// the exp2 form, rounded to bf16), each lane of a quad sums the squares of a
// quarter of the row's bf16 values in fp32 and the quad adds them up.
//
// EXP2 = true is the exp2 form (the JAX package's _EXP2 switch): q-hat =
// q*scale*log2(e), so the scores and the cap come out in the log2 domain;
// the bias is folded by log2(e), the exponent is exp2(s + bias - cap) and the
// lse divides the cap by log2(e). The natural form multiplies (s + bias -
// cap) by log2(e) before the same ex2.approx.

#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash_sm90;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

// Tile shapes for a head dim of D = 8*DN (those of the one-chain kernel).
template <int DN>
struct Tiles {
  static constexpr int D = 8 * DN;
  static constexpr int DP = (D + 15) / 16 * 16;     // depth of Q.K^T
  static constexpr int SROW = padded_row(DP);        // shared-memory row stride (elements)
  static constexpr int MT = DP <= 80 ? 2 : 1;        // m16 row tiles per warp
  static constexpr int BQ = 16 * MT * NWARPS;        // query rows per block
  static constexpr int BK = 64;                      // keys per tile
  static constexpr int NSTAGE = DP <= 64 ? 3 : 2;    // K/V stages in the ring
  static constexpr int MIN_BLOCKS = DP <= 48 ? 3 : 1;  // blocks an SM the registers must allow
  static constexpr size_t SMEM = (size_t)(BQ + NSTAGE * 2 * BK) * SROW * sizeof(bf16)
                                 + (size_t)NSTAGE * BK * sizeof(float);
};

template <int DN, bool EXP2>
__global__ void __launch_bounds__(NTHREADS, Tiles<DN>::MIN_BLOCKS)
flash_fwd_nomax_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ kmax, bf16* __restrict__ out,
                       float* __restrict__ lse, int H, int Sq, int Sk, float qscale) {
  using T = Tiles<DN>;
  constexpr int D = T::D, SROW = T::SROW, MT = T::MT, BQ = T::BQ, BK = T::BK, NSTAGE = T::NSTAGE;
  constexpr int KS = T::DP / 16;                                  // k16 steps of Q.K^T
  constexpr int NT = BK / 8;                                      // n8 score tiles per key tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                       // [BQ][SROW]
  bf16* KVs = Qs + BQ * SROW;                                     // [NSTAGE][K, V][BK][SROW]
  float* Bs = reinterpret_cast<float*>(KVs + NSTAGE * 2 * BK * SROW);  // [NSTAGE][BK] key bias

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                           // fragment row and column pair
  const long rs = (long)H * D;                                    // elements per sequence position
  const bf16* kb = k + (long)b * Sk * rs + (long)h * D;
  const bf16* vb = v + (long)b * Sk * rs + (long)h * D;
  const float* biasb = bias ? bias + (long)b * Sk : nullptr;
  const int ntiles = (Sk + BK - 1) / BK;

  // the pad columns [D, DP) of every Q/K/V row are zero, so they add nothing to q.k
  if (D < T::DP)
    for (int r = tid; r < BQ + NSTAGE * 2 * BK; r += NTHREADS)
      *reinterpret_cast<uint4*>(Qs + r * SROW + D) = make_uint4(0, 0, 0, 0);

  auto load_kv = [&](int n) {                                     // key tile n -> stage n % NSTAGE
    bf16* Kst = KVs + (n % NSTAGE) * 2 * BK * SROW;
    stage_kv<DN, BK, SROW, NTHREADS>(Kst, Kst + BK * SROW, Bs + (n % NSTAGE) * BK, kb, vb, biasb,
                                     n * BK, Sk, rs, tid);
  };
#pragma unroll
  for (int n = 0; n < NSTAGE - 1; ++n) {
    if (n < ntiles) load_kv(n);
    cp_async_commit();                                            // one group per tile, empty or not
  }

  // q-hat = q * qscale rounded to bf16, the operand of Q.K^T and of the cap
  stage_q<DN, BQ, SROW, NTHREADS, true>(Qs, q + (long)b * Sq * rs + (long)h * D, q0, Sq, rs,
                                        qscale, tid);
  __syncthreads();

  const int row0 = warp * 16 * MT;                                // this warp's first row of the tile
  uint32_t qf[MT][KS][4];                                         // Q's A fragments, for the whole loop
  load_q_fragments<MT, KS, SROW>(qf, Qs, row0, lane);

  // With a key bias, scores are biased in the log2 domain first (s =
  // x*sl + bias*log2(e), exponent factor 1); without one the factor is sl.
  const float sl = EXP2 ? 1.f : kLog2e;                           // score units -> log2 units
  const float sc = biasb ? 1.f : sl;
  const float km = kmax[bh];
  float cap[MT][2], ncap[MT][2], l[MT][2];                        // rows g and g+8 of each m16 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bf16* row = Qs + (row0 + mt * 16 + g + 8 * r) * SROW;
      float n2 = 0.f;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const float2 x =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + dn * 8 + 2 * t));
        n2 = fmaf(x.x, x.x, fmaf(x.y, x.y, n2));
      }
      cap[mt][r] = sqrtf(quad_sum(n2)) * km + 1.f;
      ncap[mt][r] = -cap[mt][r] * sl;
      l[mt][r] = 0.f;
    }
  float o[MT][DN][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dn][e] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait<NSTAGE - 2>();                                  // tile n has landed (this thread's part)
    __syncthreads();                                              // ... every thread's; tile n-1 consumed
    if (n + NSTAGE - 1 < ntiles) load_kv(n + NSTAGE - 1);         // into the stage tile n-1 left
    cp_async_commit();
    const bf16* Kst = KVs + (n % NSTAGE) * 2 * BK * SROW;
    const int k0 = n * BK;

    float s[MT][NT][4];
    qk_product<MT, KS, NT, SROW>(s, qf, Kst, lane);
    if (biasb) add_key_bias<MT, NT>(s, Bs + (n % NSTAGE) * BK, sl, t);
    if (k0 + BK > Sk) mask_keys_past<MT, NT>(s, k0, Sk, t);      // the ragged last tile

    // one exponential a score: no max, no rescale
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[mt][j][e], sc, ncap[mt][e / 2]));
          s[mt][j][e] = p;
          l[mt][e / 2] += p;
        }
    pv_product<MT, NT, DN, SROW>(o, s, Kst + BK * SROW, lane);
  }

  // epilogue: O/l through the warp's own rows of the Q tile; lse in natural log
  float inv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = fmaxf(quad_sum(l[mt][r]), 1e-30f);         // underflow row: zeros, not NaN
      inv[mt][r] = 1.f / lt;
      const int row = row0 + mt * 16 + g + 8 * r;
      if (t == 0 && q0 + row < Sq)
        lse[(long)bh * Sq + q0 + row] = (EXP2 ? cap[mt][r] / kLog2e : cap[mt][r]) + logf(lt);
    }
  store_rows<MT, DN, SROW>(out + (long)b * Sq * rs + (long)h * D, Qs, o, inv, row0, q0, Sq, rs,
                           lane);
}

constexpr int KMAX_THREADS = 512;

// kmax[b*h] = max_k |k_k| over the Sk keys of one (batch, head), each
// squared norm summed in fp32 from the bf16 values, a row a thread; one
// block per b*h.
template <int DN>
__global__ void __launch_bounds__(KMAX_THREADS)
nomax_key_max_kernel(const bf16* __restrict__ k, float* __restrict__ kmax, int H, int Sk) {
  constexpr int D = 8 * DN;
  __shared__ float warp_best[KMAX_THREADS / 32];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long rs = (long)H * D;
  const bf16* kb = k + (long)b * Sk * rs + (long)h * D;
  float best = 0.f;                                               // the largest squared norm
#pragma unroll 4
  for (int r = threadIdx.x; r < Sk; r += KMAX_THREADS) {
    float n2 = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      const uint4 u = *reinterpret_cast<const uint4*>(kb + (long)r * rs + c * 8);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(x2[i]);
        n2 = fmaf(x.x, x.x, fmaf(x.y, x.y, n2));
      }
    }
    best = fmaxf(best, n2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
  if (threadIdx.x % 32 == 0) warp_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < KMAX_THREADS / 32; ++w) best = fmaxf(best, warp_best[w]);
    kmax[bh] = sqrtf(best);                                       // sqrt is monotonic: the max of the norms
  }
}

// The pre-pass into kmax, then the attention kernel.
template <int DN, bool EXP2>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* kmax,
                   void* out, void* lse, int B, int Sq, int Sk, int H, float qscale,
                   cudaStream_t stream) {
  using T = Tiles<DN>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_nomax_kernel<DN, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  nomax_key_max_kernel<DN><<<B * H, KMAX_THREADS, 0, stream>>>(static_cast<const bf16*>(k),
                                                               static_cast<float*>(kmax), H, Sk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dim3 grid((Sq + T::BQ - 1) / T::BQ, B * H);
  flash_fwd_nomax_kernel<DN, EXP2><<<grid, NTHREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(kmax), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Sq, Sk, qscale);
  return cudaGetLastError();
}

// registers a thread, shared memory a block, query rows a block, resident blocks an SM
template <int DN, bool EXP2>
cudaError_t describe(int* info) {
  using T = Tiles<DN>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_nomax_kernel<DN, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_nomax_kernel<DN, EXP2>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_nomax_kernel<DN, EXP2>,
                                                      NTHREADS, T::SMEM);
  info[0] = attr.numRegs;
  info[1] = (int)T::SMEM;
  info[2] = T::BQ;
  info[3] = blocks;
  return err;
}

}  // namespace

#define FLASH_NOMAX_DISPATCH(CALL)                                                            \
  switch (D / 8) {                                                                            \
    CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8)                          \
    CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)                   \
    default: return (int)cudaErrorInvalidValue;                                               \
  }

// Returns a cudaError_t code: 0 when the launches were accepted. q is the raw
// q; the kernel forms q-hat = q*qscale rounded to bf16, where qscale is the
// scale (times log2(e) when exp2 != 0, the exp2 form). kmax ([B*H] f32)
// receives max_k |k_k| per (batch, head) from the pre-pass.
extern "C" int flash_attention_fwd_nomax(const void* q, const void* k, const void* v,
                                         const void* bias, void* kmax, void* out, void* lse,
                                         int B, int Sq, int Sk, int H, int D, float qscale,
                                         int exp2, void* stream) {
  if (D % 8 != 0 || D <= 0 || D > 128 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_NOMAX_LAUNCH(DN)                                                                \
  case DN:                                                                                    \
    return (int)(exp2 ? launch<DN, true>(q, k, v, bias, kmax, out, lse, B, Sq, Sk, H, qscale, s)  \
                      : launch<DN, false>(q, k, v, bias, kmax, out, lse, B, Sq, Sk, H, qscale, s));
  FLASH_NOMAX_DISPATCH(FLASH_NOMAX_LAUNCH)
#undef FLASH_NOMAX_LAUNCH
}

// The kernel's resources at head dim D: info[0..3] = registers a thread,
// shared memory a block (bytes), query rows a block, resident blocks an SM.
extern "C" int flash_attention_fwd_nomax_describe(int D, int exp2, int* info) {
  if (D % 8 != 0 || D <= 0 || D > 128) return (int)cudaErrorInvalidValue;
#define FLASH_NOMAX_DESCRIBE(DN)                                                              \
  case DN:                                                                                    \
    return (int)(exp2 ? describe<DN, true>(info) : describe<DN, false>(info));
  FLASH_NOMAX_DISPATCH(FLASH_NOMAX_DESCRIBE)
#undef FLASH_NOMAX_DESCRIBE
}
