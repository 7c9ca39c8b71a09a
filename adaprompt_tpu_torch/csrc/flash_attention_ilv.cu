// Two-chain flash attention forward for Hopper (sm_90a): the function of
// csrc/flash_attention.cu, out = softmax(q.k^T*scale + key_bias) . v plus the
// per-row natural-log logsumexp, computed as two independent online-softmax
// chains over alternating 64-key tiles that are merged exactly at the end.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fwd_kernel_ilv
// (launched from _flash_fwd_impl under the _ILV switch). Layouts as the
// one-chain kernel: q/k/v [B, S, H, D] bf16, contiguous; key_bias [B, Sk] f32
// or NULL; out [B, Sq, H, D] bf16; lse [B*H, Sq] f32 (natural log). D is a
// multiple of 8, at most 128; Sq and Sk are any lengths, equal or not.
//
// What bounds it: as the one-chain kernel, 4*D tensor-core flops and one
// exponential per score; at D=40 the exponentials bind. What the two chains
// are for: in one chain tile i+1's max, exponentials and rescale wait for
// tile i's; with two (m, l, O) states a warp issues the score products of
// both tiles of a pair before either chain's softmax update, and the two
// updates have no dependency on each other, so the scheduler may overlap one
// chain's exponentials with the other's tensor-core work.
//
// Design: the one-chain kernel's (csrc/flash_attention.cu, on the tile steps
// of csrc/flash_sm90.cuh), with two chains in each warp's registers:
// - One block per (b*h, q tile); each warp owns 16 query rows (one m16
//   tile) and both chains of those rows for the whole kernel. Two chains
//   double O and the row state and a pair doubles S, so a warp holds 16 rows,
//   where the one-chain kernel holds 32. For D <= 48 a block is four warps
//   (64 rows) with registers capped at 168, so that three blocks share an
//   SM; above, eight warps (128 rows), one block an SM, which halves the
//   K/V traffic per row. On the H100 the cap won at D=40 and four warps with
//   it lost at D=80, where it spills; eight warps won at D=80.
// - Q's A fragments are loaded once by ldmatrix and stay in registers (the
//   exp2 form folds scale*log2(e) into q first, rounded to bf16).
// - K/V come in pairs of 64-key tiles (128 keys and their key bias) through a
//   ring of two cp.async stages, with 16-byte-padded rows; chain 0 takes the
//   pair's first tile (tiles 0, 2, 4, ...), chain 1 its second (1, 3, 5, ...).
// - S = Q.K^T of both tiles by mma.m16n8k16 into registers (D padded to 16
//   for this product only), then each chain's online softmax on its tile's
//   scores: row max over the 4 lanes of a quad, alpha, ex2.approx, the row
//   sum a per-thread partial, O rescaled in registers; then O_c += P_c.V_c,
//   P straight from the score registers as bf16 A fragments, V by
//   ldmatrix.trans in n8 steps, O in fp32 registers. (Both softmax updates
//   before either P.V ran faster on the H100 than chain after chain.)
// - Every tile count is right: the loop runs over whole pairs, and an odd
//   count ends with a pair of one tile that chain 1 sits out. A chain that
//   never got a tile keeps m = -inf, l = 0, O = 0 and merges with weight
//   exp2(-inf) = 0, without a NaN (chain 0 always has tile 0, so the joint max
//   is finite). The merge is the online-softmax rescale applied once more:
//   m = max(m0, m1), l = l0*2^(m0-m) + l1*2^(m1-m), O likewise.
// - Epilogue: O/l is rounded to bf16, staged in the warp's own rows of the Q
//   tile and stored 16 bytes a lane; lse = m/log2(e) + log(l).
// Masked keys carry a finite NEG_BIG bias: a row whose keys are all masked
// gets equal weights (the mean of v), as the one-chain kernel.
//
// EXP2 = true is the exp2 form (the JAX package's _EXP2 switch): scale*log2(e)
// folded into the staged q tile, rounded to bf16, and log2(e) into the bias.
// The natural form applies the scale to the fp32 score, as the one-chain
// kernel does.

#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash_sm90;

// Tile shapes for a head dim of D = 8*DN.
template <int DN>
struct Tiles {
  static constexpr int D = 8 * DN;
  static constexpr int DP = (D + 15) / 16 * 16;     // depth of Q.K^T
  static constexpr int SROW = padded_row(DP);        // shared-memory row stride (elements)
  static constexpr int NWARPS = DP <= 48 ? 4 : 8;    // warps a block
  static constexpr int NTHREADS = 32 * NWARPS;
  static constexpr int MIN_BLOCKS = DP <= 48 ? 3 : 1;  // blocks an SM the registers must allow
  static constexpr int BQ = 16 * NWARPS;             // query rows per block (16 a warp)
  static constexpr int BK = 64;                      // keys per tile (ops/attention.py ILV_BLOCK_K)
  static constexpr int NSTAGE = 2;                   // stages of a pair of tiles in the ring
  static constexpr size_t SMEM = (size_t)(BQ + NSTAGE * 4 * BK) * SROW * sizeof(bf16)
                                 + (size_t)NSTAGE * 2 * BK * sizeof(float);
};

// One chain's online-softmax step on its tile's scores s (turned into p):
// rows g (e = 0, 1) and g+8 (e = 2, 3); O and the row sum rescaled by alpha.
template <int NT, int DN>
__device__ __forceinline__ void chain_softmax(float (&s)[1][NT][4], float (&o)[1][DN][4],
                                              float (&m)[2], float (&l)[2], float sc) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[0][j][2 * r], s[0][j][2 * r + 1]));
    mx = quad_max(mx);
    const float alpha = exp2_approx((m[r] - mx) * sc);            // 0 on the chain's first tile
    m[r] = mx;
    const float msc = mx * sc;
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float p = exp2_approx(fmaf(s[0][j][e], sc, -msc));
        s[0][j][e] = p;
        rsum += p;
      }
    l[r] = l[r] * alpha + rsum;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[0][dn][2 * r] *= alpha;
      o[0][dn][2 * r + 1] *= alpha;
    }
  }
}

template <int DN, bool EXP2>
__global__ void __launch_bounds__(Tiles<DN>::NTHREADS, Tiles<DN>::MIN_BLOCKS)
flash_fwd_ilv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse,
                     int H, int Sq, int Sk, float scale_log2) {
  using T = Tiles<DN>;
  constexpr int D = T::D, SROW = T::SROW, BQ = T::BQ, BK = T::BK, NSTAGE = T::NSTAGE;
  constexpr int NTHREADS = T::NTHREADS;
  constexpr int KS = T::DP / 16;                                  // k16 steps of Q.K^T
  constexpr int NT = BK / 8;                                      // n8 score tiles per key tile
  constexpr int STAGE = 4 * BK * SROW;                            // K then V of a pair: [2*BK][SROW] each
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                       // [BQ][SROW]
  bf16* KVs = Qs + BQ * SROW;                                     // [NSTAGE][K, V][2*BK][SROW]
  float* Bs = reinterpret_cast<float*>(KVs + NSTAGE * STAGE);     // [NSTAGE][2*BK] key bias

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;                                         // fragment column pair
  const long rs = (long)H * D;                                    // elements per sequence position
  const bf16* kb = k + (long)b * Sk * rs + (long)h * D;
  const bf16* vb = v + (long)b * Sk * rs + (long)h * D;
  const float* biasb = bias ? bias + (long)b * Sk : nullptr;
  const int npairs = (Sk + 2 * BK - 1) / (2 * BK);

  // the pad columns [D, DP) of every Q/K/V row are zero, so they add nothing to q.k
  if (D < T::DP)
    for (int r = tid; r < BQ + NSTAGE * 4 * BK; r += NTHREADS)
      *reinterpret_cast<uint4*>(Qs + r * SROW + D) = make_uint4(0, 0, 0, 0);

  auto load_pair = [&](int n) {                                   // keys of pair n -> stage n % NSTAGE
    bf16* Kst = KVs + (n % NSTAGE) * STAGE;
    stage_kv<DN, 2 * BK, SROW, NTHREADS>(Kst, Kst + 2 * BK * SROW, Bs + (n % NSTAGE) * 2 * BK,
                                         kb, vb, biasb, n * 2 * BK, Sk, rs, tid);
  };
  load_pair(0);
  cp_async_commit();

  stage_q<DN, BQ, SROW, NTHREADS, EXP2>(Qs, q + (long)b * Sq * rs + (long)h * D, q0, Sq, rs,
                                        scale_log2, tid);         // exp2: q-hat, scores in log2
  __syncthreads();

  const int row0 = warp * 16;                                     // this warp's rows of the tile
  uint32_t qf[1][KS][4];                                          // Q's A fragments, for the whole loop
  load_q_fragments<1, KS, SROW>(qf, Qs, row0, lane);

  // With a key bias, scores are biased in the log2 domain before the max
  // (s = x*scale_log2 + bias*log2(e), exponent factor 1); without one, s is
  // the raw product and the factor is the scale.
  const float sl2 = EXP2 ? 1.f : scale_log2;
  const float sc = biasb ? 1.f : sl2;
  float o0[1][DN][4], o1[1][DN][4];                               // chain 0's and chain 1's O
  float m0[2], l0[2], m1[2], l1[2];                               // rows g and g+8
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o0[0][dn][e] = o1[0][dn][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m0[r] = m1[r] = -INFINITY;
    l0[r] = l1[r] = 0.f;
  }

  for (int n = 0; n < npairs; ++n) {
    cp_async_wait<0>();                                           // pair n has landed (this thread's part)
    __syncthreads();                                              // ... every thread's; pair n-1 consumed
    if (n + 1 < npairs) load_pair(n + 1);                         // into the stage pair n-1 left
    cp_async_commit();
    const bf16* Kst = KVs + (n % NSTAGE) * STAGE;
    const bf16* Vst = Kst + 2 * BK * SROW;
    const float* Bst = Bs + (n % NSTAGE) * 2 * BK;
    const int k0 = n * 2 * BK;

    float s0[1][NT][4], s1[1][NT][4];
    if (k0 + BK < Sk) {                                           // both tiles: the chains side by side
      qk_product<1, KS, NT, SROW>(s0, qf, Kst, lane);
      qk_product<1, KS, NT, SROW>(s1, qf, Kst + BK * SROW, lane);
      if (biasb) {
        add_key_bias<1, NT>(s0, Bst, sl2, t);
        add_key_bias<1, NT>(s1, Bst + BK, sl2, t);
      }
      if (k0 + 2 * BK > Sk) mask_keys_past<1, NT>(s1, k0 + BK, Sk, t);  // ragged second tile
      chain_softmax<NT, DN>(s0, o0, m0, l0, sc);
      chain_softmax<NT, DN>(s1, o1, m1, l1, sc);
      pv_product<1, NT, DN, SROW>(o0, s0, Vst, lane);
      pv_product<1, NT, DN, SROW>(o1, s1, Vst + BK * SROW, lane);
    } else {                                                      // the last pair of an odd count: chain 0 only
      qk_product<1, KS, NT, SROW>(s0, qf, Kst, lane);
      if (biasb) add_key_bias<1, NT>(s0, Bst, sl2, t);
      if (k0 + BK > Sk) mask_keys_past<1, NT>(s0, k0, Sk, t);
      chain_softmax<NT, DN>(s0, o0, m0, l0, sc);
      pv_product<1, NT, DN, SROW>(o0, s0, Vst, lane);
    }
  }

  // merge the chains on their joint max, then the epilogue
  float inv[1][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m = fmaxf(m0[r], m1[r]);                          // finite: chain 0 saw tile 0
    const float w0 = exp2_approx((m0[r] - m) * sc);
    const float w1 = exp2_approx((m1[r] - m) * sc);               // an empty chain: exp2(-inf) = 0
    const float lt = quad_sum(l0[r] * w0 + l1[r] * w1);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o0[0][dn][2 * r] = o0[0][dn][2 * r] * w0 + o1[0][dn][2 * r] * w1;
      o0[0][dn][2 * r + 1] = o0[0][dn][2 * r + 1] * w0 + o1[0][dn][2 * r + 1] * w1;
    }
    inv[0][r] = 1.f / lt;
    const int row = row0 + lane / 4 + 8 * r;
    if (t == 0 && q0 + row < Sq) lse[(long)bh * Sq + q0 + row] = m * sc / kLog2e + logf(lt);
  }
  store_rows<1, DN, SROW>(out + (long)b * Sq * rs + (long)h * D, Qs, o0, inv, row0, q0, Sq, rs,
                          lane);
}

template <int DN, bool EXP2>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* out, void* lse, int B, int Sq, int Sk, int H,
                   float scale, cudaStream_t stream) {
  using T = Tiles<DN>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_ilv_kernel<DN, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + T::BQ - 1) / T::BQ, B * H);
  flash_fwd_ilv_kernel<DN, EXP2><<<grid, T::NTHREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<float*>(lse),
      H, Sq, Sk, scale * kLog2e);
  return cudaGetLastError();
}

// registers a thread, shared memory a block, query rows a block, resident blocks an SM
template <int DN, bool EXP2>
cudaError_t describe(int* info) {
  using T = Tiles<DN>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_ilv_kernel<DN, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_ilv_kernel<DN, EXP2>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_ilv_kernel<DN, EXP2>,
                                                      T::NTHREADS, T::SMEM);
  info[0] = attr.numRegs;
  info[1] = (int)T::SMEM;
  info[2] = T::BQ;
  info[3] = blocks;
  return err;
}

}  // namespace

#define FLASH_ILV_DISPATCH(CALL)                                                              \
  switch (D / 8) {                                                                            \
    CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8)                          \
    CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)                   \
    default: return (int)cudaErrorInvalidValue;                                               \
  }

// Returns a cudaError_t code: 0 when the launch was accepted. exp2 != 0
// selects the exp2 form.
extern "C" int flash_attention_fwd_ilv(const void* q, const void* k, const void* v,
                                       const void* bias, void* out, void* lse,
                                       int B, int Sq, int Sk, int H, int D,
                                       float scale, int exp2, void* stream) {
  if (D % 8 != 0 || D <= 0 || D > 128 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ILV_LAUNCH(DN)                                                                  \
  case DN:                                                                                    \
    return (int)(exp2 ? launch<DN, true>(q, k, v, bias, out, lse, B, Sq, Sk, H, scale, s)     \
                      : launch<DN, false>(q, k, v, bias, out, lse, B, Sq, Sk, H, scale, s));
  FLASH_ILV_DISPATCH(FLASH_ILV_LAUNCH)
#undef FLASH_ILV_LAUNCH
}

// The kernel's resources at head dim D: info[0..3] = registers a thread,
// shared memory a block (bytes), query rows a block, resident blocks an SM.
extern "C" int flash_attention_fwd_ilv_describe(int D, int exp2, int* info) {
  if (D % 8 != 0 || D <= 0 || D > 128) return (int)cudaErrorInvalidValue;
#define FLASH_ILV_DESCRIBE(DN)                                                                \
  case DN:                                                                                    \
    return (int)(exp2 ? describe<DN, true>(info) : describe<DN, false>(info));
  FLASH_ILV_DISPATCH(FLASH_ILV_DESCRIBE)
#undef FLASH_ILV_DESCRIBE
}
