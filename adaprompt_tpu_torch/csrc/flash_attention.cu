// Flash attention forward for Hopper (sm_90a): out = softmax(q.k^T*scale +
// key_bias) . v with an fp32 online softmax, plus the per-row logsumexp.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fwd_kernel
// (launched from _flash_fwd_impl). Layouts are the JAX package's:
// q/k/v [B, S, H, D] bf16, contiguous; key_bias [B, Sk] f32 or NULL;
// out [B, Sq, H, D] bf16; lse [B*H, Sq] f32 (natural log). D is a multiple
// of 8, at most 128; Sq and Sk are any lengths, equal or not.
//
// What bounds it: each score costs 4*D tensor-core flops (QK^T and PV) and
// one exponential. At the UNet's D=40 that is 160 flops, ~0.04 SM cycles at
// the H100's ~4096 dense bf16 flop/cycle/SM, against 1/16 SM cycle for the
// exponential at 16/cycle/SM: the exponentials bind, then the tensor cores,
// and every other instruction of the softmax competes with both for dispatch.
// Bytes are small (q/k/v/out once each; K/V are re-read from L2 by every
// q tile, once per 64 or 128 query rows).
//
// Design (FlashAttention-2 on mma.sync; the helpers are in flash_sm90.cuh):
// - One block of four warps per (b*h, q tile). The q tile is 128 rows for
//   D <= 80 (each warp owns 32 rows: two m16 tiles, so each K/V fragment
//   read from shared memory feeds two products) and 64 rows above (each warp
//   owns 16; the O accumulator of D=96..128 leaves no registers for a second
//   row tile). A warp owns its rows for the whole kernel. On the H100 two row
//   tiles a warp beat one at D=80 S=1024 by far, though D=80 then takes 255
//   registers and spills a few bytes, and two blocks an SM (~210-255
//   registers) beat three (registers capped at 168, with spills) at D=40.
// - Q is staged once and its A fragments are loaded with ldmatrix into
//   registers, where they stay for the whole key loop (the exp2 form folds
//   scale*log2(e) into q first, rounded to bf16, as the TPU kernel does).
// - S = Q.K^T by mma.m16n8k16 (bf16 in, fp32 out) into registers. Only this
//   product pads D to a multiple of 16 (40 -> 48): the pad columns are zero
//   in shared memory, never in device memory.
// - The online softmax runs on those registers: a thread holds two rows of
//   each m16 tile, so the row max reduces over the 4 lanes of a quad (two
//   shuffles); the row sum stays a per-thread partial, rescaled with O, and
//   is reduced once at the end. With no key bias the max is taken on the raw
//   product and the scale folds into the exponent's multiply-add; with one,
//   the bias is added first (one multiply-add a score). Keys past Sk in the
//   ragged last tile get -inf.
// - P never touches shared memory: the score registers of two neighbouring
//   n8 tiles, rounded to bf16 in pairs, are the A fragment of O += P.V, whose
//   B fragments come from V by ldmatrix.trans. That product runs over D in n8
//   steps, so D=40 needs no pad there. O stays in fp32 registers, rescaled
//   there by alpha.
// - K/V tiles of 64 keys, and the tile's 64 key-bias values, flow through a
//   ring of cp.async stages (three for D <= 64, two above), with copies that
//   zero-fill the keys past Sk; the next tile is in flight while the current
//   one computes, and one block barrier per tile both publishes a landed
//   stage and frees the stage about to be refilled. (Read straight from
//   device memory inside the loop, the bias exposed its latency every tile.)
//   Shared-memory rows are padded by 16 bytes (an odd number of 16-byte units
//   a row), so ldmatrix reads them without bank conflicts.
// - Epilogue: O/l is rounded to bf16, staged in the warp's own rows of the Q
//   tile and stored 16 bytes a lane; lse = m/log2(e) + log(l).
// l is summed in fp32 from the unrounded p; P is rounded to bf16 before P.V.
// Masked keys carry a finite NEG_BIG bias: a row whose keys are all masked
// gets equal weights (the mean of v), as the plain softmax gives.
//
// The exp2 form (EXP2 = true; the JAX package's _EXP2 switch on _fwd_kernel):
// scale*log2(e) is folded into the q tile as it is staged, rounded to bf16
// there as the TPU kernel rounds its q tile, so a score leaves the tensor
// cores already in the log2 domain. Both forms end in ex2.approx and both
// write the natural-log lse. The rounding of the folded q makes the two forms
// differ in the last bf16 digits of the scores.

#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash_sm90;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// Tile shapes for a head dim of D = 8*DN.
template <int DN>
struct Tiles {
  static constexpr int D = 8 * DN;
  static constexpr int DP = (D + 15) / 16 * 16;     // depth of Q.K^T
  static constexpr int SROW = padded_row(DP);        // shared-memory row stride (elements)
  static constexpr int MT = DP <= 80 ? 2 : 1;        // m16 row tiles per warp
  static constexpr int BQ = 16 * MT * NWARPS;        // query rows per block
  static constexpr int BK = 64;                      // keys per tile
  static constexpr int NSTAGE = DP <= 64 ? 3 : 2;    // K/V stages in the ring
  static constexpr size_t SMEM = (size_t)(BQ + NSTAGE * 2 * BK) * SROW * sizeof(bf16)
                                 + (size_t)NSTAGE * BK * sizeof(float);
};

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

template <int DN, bool EXP2>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ out, float* __restrict__ lse,
                 int H, int Sq, int Sk, float scale_log2) {
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
  const bf16* qb = q + (long)b * Sq * rs + (long)h * D;
  const bf16* kb = k + (long)b * Sk * rs + (long)h * D;
  const bf16* vb = v + (long)b * Sk * rs + (long)h * D;
  const float* biasb = bias ? bias + (long)b * Sk : nullptr;
  const int ntiles = (Sk + BK - 1) / BK;

  // the pad columns [D, DP) of every Q/K/V row are zero, so they add nothing to q.k
  if (D < T::DP)
    for (int r = tid; r < BQ + NSTAGE * 2 * BK; r += NTHREADS)
      *reinterpret_cast<uint4*>(Qs + r * SROW + D) = make_uint4(0, 0, 0, 0);

  // key tile n (and its bias) -> stage n % NSTAGE; keys past Sk are
  // zero-filled, not read
  auto load_kv = [&](int n) {
    bf16* Kst = KVs + (n % NSTAGE) * 2 * BK * SROW;
    bf16* Vst = Kst + BK * SROW;
    const int k0 = n * BK;
    for (int i = tid; i < BK * DN; i += NTHREADS) {
      const int r = i / DN, c = (i % DN) * 8;
      const bool ok = k0 + r < Sk;
      const long off = ok ? (long)(k0 + r) * rs + c : 0;
      cp_async_16(smem_addr(Kst + r * SROW + c), kb + off, ok);
      cp_async_16(smem_addr(Vst + r * SROW + c), vb + off, ok);
    }
    if (biasb && tid < BK) {
      const bool ok = k0 + tid < Sk;
      cp_async_4(smem_addr(Bs + (n % NSTAGE) * BK + tid), biasb + (ok ? k0 + tid : 0), ok);
    }
  };
#pragma unroll
  for (int n = 0; n < NSTAGE - 1; ++n) {
    if (n < ntiles) load_kv(n);
    cp_async_commit();                                            // one group per tile, empty or not
  }

  for (int i = tid; i < BQ * DN; i += NTHREADS) {
    const int r = i / DN, c = (i % DN) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (long)(q0 + r) * rs + c);
    if (EXP2) val = scale_bf16x8(val, scale_log2);             // q-hat: scores come out in log2
    *reinterpret_cast<uint4*>(Qs + r * SROW + c) = val;
  }
  __syncthreads();

  const int row0 = warp * 16 * MT;                                // this warp's first row of the tile
  uint32_t qf[MT][KS][4];                                         // Q's A fragments, for the whole loop
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[mt][kk], smem_addr(Qs + (row0 + mt * 16 + lane % 8 + (lane / 8) % 2 * 8) * SROW
                                        + kk * 16 + lane / 16 * 8));

  // With a key bias, scores are biased in the log2 domain before the max
  // (s = x*scale_log2 + bias*log2(e), exponent factor 1); without one, s is
  // the raw product and the factor is the scale.
  const float sl2 = EXP2 ? 1.f : scale_log2;
  const float sc = biasb ? 1.f : sl2;
  float o[MT][DN][4];
  float m[MT][2], l[MT][2];                                       // rows g and g+8 of each m16 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dn][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) { m[mt][r] = -INFINITY; l[mt][r] = 0.f; }
  }

  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait<NSTAGE - 2>();                                  // tile n has landed (this thread's part)
    __syncthreads();                                              // ... every thread's; tile n-1 consumed
    if (n + NSTAGE - 1 < ntiles) load_kv(n + NSTAGE - 1);         // into the stage tile n-1 left
    cp_async_commit();
    const bf16* Kst = KVs + (n % NSTAGE) * 2 * BK * SROW;
    const bf16* Vst = Kst + BK * SROW;
    const float* Bst = Bs + (n % NSTAGE) * BK;
    const int k0 = n * BK;

    // S = Q K^T: [16*MT x 64] per warp, fp32 in registers
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t kf[4];                                           // B fragments of n8 tiles 2*j2, 2*j2+1
        ldmatrix_x4(kf, smem_addr(Kst + (j2 * 16 + lane % 8 + lane / 16 * 8) * SROW
                                  + kk * 16 + (lane / 8) % 2 * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(s[mt][2 * j2], qf[mt][kk], kf[0], kf[1]);
          mma_bf16_16816(s[mt][2 * j2 + 1], qf[mt][kk], kf[2], kf[3]);
        }
      }
    }
    if (biasb) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 kb2 = *reinterpret_cast<const float2*>(Bst + j * 8 + 2 * t);
        const float b0 = kb2.x * LOG2E, b1 = kb2.y * LOG2E;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          s[mt][j][0] = fmaf(s[mt][j][0], sl2, b0);
          s[mt][j][1] = fmaf(s[mt][j][1], sl2, b1);
          s[mt][j][2] = fmaf(s[mt][j][2], sl2, b0);
          s[mt][j][3] = fmaf(s[mt][j][3], sl2, b1);
        }
      }
    }
    if (k0 + BK > Sk) {                                           // the ragged last tile
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = k0 + j * 8 + 2 * t;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (c >= Sk) s[mt][j][0] = s[mt][j][2] = -INFINITY;
          if (c + 1 >= Sk) s[mt][j][1] = s[mt][j][3] = -INFINITY;
        }
      }
    }

    // online softmax, in registers: rows g (e = 0, 1) and g+8 (e = 2, 3)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mt][r];
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
        mx = quad_max(mx);
        const float alpha = exp2_approx((m[mt][r] - mx) * sc);   // 0 on the first tile
        m[mt][r] = mx;
        const float msc = mx * sc;
        float rsum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = exp2_approx(fmaf(s[mt][j][e], sc, -msc));
            s[mt][j][e] = p;
            rsum += p;
          }
        l[mt][r] = l[mt][r] * alpha + rsum;
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          o[mt][dn][2 * r] *= alpha;
          o[mt][dn][2 * r + 1] *= alpha;
        }
      }
    }

    // O += P V: P from the score registers as bf16 A fragments, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
      const bf16* vrow = Vst + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * SROW;
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t vf[4];                                           // B fragments of n8 tiles 2*dp, 2*dp+1
        ldmatrix_x4_trans(vf, smem_addr(vrow + dp * 16 + lane / 16 * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(o[mt][2 * dp], pa[mt], vf[0], vf[1]);
          mma_bf16_16816(o[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
        }
      }
      if (DN % 2) {                                               // the odd last n8 tile (D = 40: d 32..39)
        uint32_t vf[2];
        ldmatrix_x2_trans(vf, smem_addr(vrow + (DN - 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(o[mt][DN - 1], pa[mt], vf[0], vf[1]);
      }
    }
  }

  // epilogue: O/l as bf16 into this warp's own rows of the Q tile (no other
  // warp reads them), then 16-byte stores; lse in natural log
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = quad_sum(l[mt][r]);
      const float inv = 1.f / lt;
      const int row = row0 + mt * 16 + g + 8 * r;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        *reinterpret_cast<uint32_t*>(Qs + row * SROW + dn * 8 + 2 * t) =
            pack_bf16(o[mt][dn][2 * r] * inv, o[mt][dn][2 * r + 1] * inv);
      if (t == 0 && q0 + row < Sq) lse[(long)bh * Sq + q0 + row] = m[mt][r] * sc / LOG2E + logf(lt);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * MT * DN; i += 32) {
    const int row = row0 + i / DN, c = (i % DN) * 8;
    if (q0 + row < Sq)
      *reinterpret_cast<uint4*>(out + ((long)b * Sq + q0 + row) * rs + (long)h * D + c) =
          *reinterpret_cast<const uint4*>(Qs + row * SROW + c);
  }
}

template <int DN, bool EXP2>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   void* out, void* lse, int B, int Sq, int Sk, int H,
                   float scale, cudaStream_t stream) {
  using T = Tiles<DN>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DN, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + T::BQ - 1) / T::BQ, B * H);
  flash_fwd_kernel<DN, EXP2><<<grid, NTHREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<float*>(lse),
      H, Sq, Sk, scale * LOG2E);
  return cudaGetLastError();
}

// registers a thread, shared memory a block, query rows a block, resident blocks an SM
template <int DN, bool EXP2>
cudaError_t describe(int* info) {
  using T = Tiles<DN>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DN, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_kernel<DN, EXP2>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_kernel<DN, EXP2>,
                                                      NTHREADS, T::SMEM);
  info[0] = attr.numRegs;
  info[1] = (int)T::SMEM;
  info[2] = T::BQ;
  info[3] = blocks;
  return err;
}

}  // namespace

#define FLASH_FWD_DISPATCH(CALL)                                                              \
  switch (D / 8) {                                                                            \
    CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8)                          \
    CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)                   \
    default: return (int)cudaErrorInvalidValue;                                               \
  }

// Returns a cudaError_t code: 0 when the launch was accepted. exp2 != 0
// selects the exp2 form.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, void* lse,
                                   int B, int Sq, int Sk, int H, int D,
                                   float scale, int exp2, void* stream) {
  if (D % 8 != 0 || D <= 0 || D > 128 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_LAUNCH(DN)                                                                  \
  case DN:                                                                                    \
    return (int)(exp2 ? launch<DN, true>(q, k, v, bias, out, lse, B, Sq, Sk, H, scale, s)     \
                      : launch<DN, false>(q, k, v, bias, out, lse, B, Sq, Sk, H, scale, s));
  FLASH_FWD_DISPATCH(FLASH_FWD_LAUNCH)
#undef FLASH_FWD_LAUNCH
}

// The kernel's resources at head dim D: info[0..3] = registers a thread,
// shared memory a block (bytes), query rows a block, resident blocks an SM.
extern "C" int flash_attention_fwd_describe(int D, int exp2, int* info) {
  if (D % 8 != 0 || D <= 0 || D > 128) return (int)cudaErrorInvalidValue;
#define FLASH_FWD_DESCRIBE(DN)                                                                \
  case DN:                                                                                    \
    return (int)(exp2 ? describe<DN, true>(info) : describe<DN, false>(info));
  FLASH_FWD_DISPATCH(FLASH_FWD_DESCRIBE)
#undef FLASH_FWD_DESCRIBE
}
