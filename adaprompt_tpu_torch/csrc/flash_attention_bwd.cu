// Flash attention backward for Hopper (sm_90a): the FlashAttention-2
// recomputation backward from the forward's logsumexp.
//
//   p  = exp(q.k^T*scale + key_bias - lse)      (recomputed, never stored)
//   dV = p^T . dO
//   dS = p * (dO.v^T - delta),  delta = rowsum(dO * O)
//   dQ = dS . k * scale
//   dK = dS^T . q * scale
//
// Replaces the TPU kernels adaprompt_tpu/ops/attention.py::_dq_kernel and
// ::_dkv_kernel (launched from _flash_bwd_impl), and the delta that
// _flash_bwd_impl leaves to XLA. Layouts are the JAX package's: q/k/v/out/dO
// [B, S, H, D] bf16, contiguous; key_bias [B, Sk] f32 or NULL; lse
// [B*H, Sq] f32 (natural log); dq/dk/dv [B, S, H, D] bf16. D is a multiple of
// 8, at most 128; Sq and Sk are any lengths, equal or not. The key bias gets
// no gradient.
//
// What bounds it: 5 products of S^2*D per head (S^T = K.Q^T, dP^T = V.dO^T,
// dV += P^T.dO, dK += dS^T.Q, dQ = dS.K), 10*D tensor-core flops a score, and
// one exponential a score. At the UNet's D=40 that is 400 flops, ~0.1 SM
// cycles at the H100's ~4096 dense bf16 flop/cycle/SM (more on mma.sync),
// against 1/16 cycle for the exponential: the tensor cores bind, then the
// exponentials and the ~6 other fp32 operations a score. Bytes are small
// (each operand read once from device memory; Q/dO re-read from L2 per key
// tile); the dQ sums are 4*D bytes of atomics per score row and key tile.
//
// Design (one kernel over key tiles, on the helpers of flash_sm90.cuh):
// - One block of four warps per (b*h, key tile of 64 keys); each warp owns 16
//   keys for the whole kernel. K and V of the tile are staged once; each
//   warp's A fragments of K and V are loaded once by ldmatrix and stay in
//   registers, as B1 keeps Q's. dK and dV stay in fp32 registers throughout.
// - Q, dO and the rows' (lse*log2(e), delta) stream through a two-stage
//   cp.async ring, q tiles of 64 rows (32 for D = 88, 96; 16 above, where the
//   dK/dV sums leave fewer registers); rows past Sq are zero-filled (their dO
//   is zero, so they add nothing). Blocks start the ring at different q
//   tiles, so the blocks of one head add into different dQ rows at a time.
// - S^T and dP^T come out of mma.m16n8k16 in registers with the keys as rows;
//   P^T = exp2(s^T*c + bias - lse) and dS^T = P^T*(dP^T - delta) are formed
//   there (ex2.approx) and rounded to bf16 in pairs, which makes them the A
//   fragments of dV += P^T.dO and dK += dS^T.Q straight from the registers;
//   dO and Q are the B operands, by ldmatrix.trans in n8 steps (D=40 is not
//   padded there; only the two products over D pad it to 48).
// - dQ needs dS with the q rows as rows: dS^T is written once per q tile to
//   shared memory as bf16 (rows padded to an odd number of 16-byte units, so
//   ldmatrix is free of bank conflicts), read back transposed by
//   ldmatrix.trans, and each warp multiplies its share of q rows and head
//   columns by the K tile still in shared memory. Its fp32 partial sums are
//   added into a [B, Sq, H, D] fp32 scratch with atomics, so the sum order
//   of dQ, and its last bits, change from run to run (dK and dV do not).
//   Five products and one exponential a score, against the 7 and 2 of a
//   split into a dQ kernel and a dK/dV kernel.
// - Two more kernels in the same C call: a pre-pass, one thread a row, writes
//   (lse*log2(e), delta = rowsum(dO*O)) in fp32 and zeroes the dQ scratch; an
//   epilogue writes dq = bf16(scratch*scale) with 16-byte stores.
// P and dS are rounded to bf16 before their products, as the Pallas kernels
// do; every sum is fp32. Keys past Sk get p = 0 (a -inf bias) and their dK,
// dV rows are not written. Masked keys carry a finite NEG_BIG bias and the
// scores are biased before lse is subtracted, as the plain version does, so a
// row whose keys are all masked gets the plain version's p (exp of the
// difference of two equal fp32 values), never a NaN.
//
// The exp2 form (EXP2 = true; the JAX package's _EXP2 switch on both
// kernels): scale*log2(e) is folded into the q tile, rounded to bf16 as the
// TPU kernels round it (each thread scales the 16-byte chunks its own copies
// wrote, once they have landed), and log2(e) into the bias and lse, so the
// scores leave the tensor cores in the log2 domain. dQ keeps its factor of
// scale; dK = dS^T.q-hat already carries scale*log2(e) and is divided by
// log2(e) at the end. lse arrives in natural log either way.

#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash_sm90;

constexpr int AUX_THREADS = 256;    // threads a block of the pre-pass and the epilogue

// Tile shapes for a head dim of D = 8*DN.
template <int DN>
struct Tiles {
  static constexpr int D = 8 * DN;
  static constexpr int DP = (D + 15) / 16 * 16;     // depth of S^T = K.Q^T and dP^T = V.dO^T
  static constexpr int SROW = padded_row(DP);        // shared-memory row stride of K, V, Q, dO
  static constexpr int NWARPS = 4;
  static constexpr int NTHREADS = 32 * NWARPS;
  static constexpr int BK = 16 * NWARPS;             // keys a block, 16 a warp
  static constexpr int BQ = DP <= 80 ? 64 : DP <= 96 ? 32 : 16;   // q rows a streamed tile
  static constexpr int DSROW = padded_row(BQ);       // row stride of the dS^T tile
  static constexpr int NSTAGE = 2;                   // q tiles in the cp.async ring
  static constexpr int MIN_BLOCKS = DP <= 48 ? 3 : 2;  // blocks an SM the registers must allow
  static constexpr size_t SMEM = (size_t)(2 * BK + NSTAGE * 2 * BQ) * SROW * sizeof(bf16)
                                 + (size_t)NSTAGE * BQ * sizeof(float2)
                                 + (size_t)BK * DSROW * sizeof(bf16);
};

// 8 bytes global -> shared (cached in L1 too); zero-filled when !valid.
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

// dst[0..1] += (a, b) in device memory: sm_90's vector atomic add, its
// result unused (a reduction). dst is 8-byte aligned.
__device__ __forceinline__ void add2_global(float* dst, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
}

// acc (16 rows x 8*DN, fp32) += A . Bst, with A the packed bf16 fragments of a
// 16 x 16*KT operand (score registers of the C layout, rounded in pairs) and
// Bst a row-major [16*KT][SROW] tile, read by ldmatrix.trans in n8 steps (an
// odd last step by ldmatrix.x2.trans).
template <int KT, int DN, int SROW>
__device__ __forceinline__ void times_tile(float (&acc)[DN][4], const uint32_t (&a)[KT][4],
                                           const bf16* Bst, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const bf16* brow = Bst + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * SROW;
#pragma unroll
    for (int dp = 0; dp < DN / 2; ++dp) {
      uint32_t bfr[4];                                            // B fragments of n8 tiles 2*dp, 2*dp+1
      ldmatrix_x4_trans(bfr, smem_addr(brow + dp * 16 + lane / 16 * 8));
      mma_bf16_16816(acc[2 * dp], a[kk], bfr[0], bfr[1]);
      mma_bf16_16816(acc[2 * dp + 1], a[kk], bfr[2], bfr[3]);
    }
    if (DN % 2) {
      uint32_t bfr[2];
      ldmatrix_x2_trans(bfr, smem_addr(brow + (DN - 1) * 8));
      mma_bf16_16816(acc[DN - 1], a[kk], bfr[0], bfr[1]);
    }
  }
}

template <int DN, bool EXP2>
__global__ void __launch_bounds__(Tiles<DN>::NTHREADS, Tiles<DN>::MIN_BLOCKS)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const bf16* __restrict__ dout, const float2* __restrict__ ld,
                 float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int H, int Sq, int Sk, float sl2, float qscale, float dk_scale) {
  using T = Tiles<DN>;
  constexpr int D = T::D, SROW = T::SROW, BK = T::BK, BQ = T::BQ, DSROW = T::DSROW;
  constexpr int NSTAGE = T::NSTAGE, NTHREADS = T::NTHREADS;
  constexpr int KS = T::DP / 16;                                  // k16 steps of the products over D
  constexpr int NT = BQ / 8;                                      // n8 score tiles per q tile
  constexpr int KT = BQ / 16;                                     // k16 steps of the products over q
  constexpr int STAGE = 2 * BQ * SROW;                            // Q then dO
  // dQ of a q tile: m16 row tile mq and n8 columns [dn0, dn0 + NDQ) a warp
  constexpr int MQ = BQ / 16, WPM = T::NWARPS / MQ, NDQ = (DN + WPM - 1) / WPM;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);                       // [BK][SROW]
  bf16* Vs = Ks + BK * SROW;                                      // [BK][SROW]
  bf16* QdOs = Vs + BK * SROW;                                    // [NSTAGE][Q, dO][BQ][SROW]
  float2* LDs = reinterpret_cast<float2*>(QdOs + NSTAGE * STAGE);  // [NSTAGE][BQ] (lse*log2e, delta)
  bf16* dSs = reinterpret_cast<bf16*>(LDs + NSTAGE * BQ);         // [BK][DSROW] dS^T

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                           // fragment row and column pair
  const long rs = (long)H * D;                                    // elements per sequence position
  const bf16* qb = q + (long)b * Sq * rs + (long)h * D;
  const bf16* dob = dout + (long)b * Sq * rs + (long)h * D;
  const long koff = (long)b * Sk * rs + (long)h * D;
  const float2* ldb = ld + (long)bh * Sq;
  float* dqb = dq_acc + (long)b * Sq * rs + (long)h * D;
  const int nqt = (Sq + BQ - 1) / BQ;

  // the pad columns [D, DP) of every K/V/Q/dO row are zero, so they add
  // nothing to the products over D
  if (D < T::DP)
    for (int r = tid; r < 2 * BK + NSTAGE * 2 * BQ; r += NTHREADS)
      *reinterpret_cast<uint4*>(Ks + r * SROW + D) = make_uint4(0, 0, 0, 0);

  stage_kv<DN, BK, SROW, NTHREADS>(Ks, Vs, nullptr, k + koff, v + koff, nullptr, k0, Sk, rs, tid);

  // the q tile of step n (blocks start at different tiles) -> stage n % NSTAGE
  auto tile_q0 = [&](int n) { return (n + (int)blockIdx.x) % nqt * BQ; };
  auto load_q = [&](int n) {
    const int q0 = tile_q0(n);
    bf16* Qst = QdOs + (n % NSTAGE) * STAGE;
    for (int i = tid; i < BQ * DN; i += NTHREADS) {
      const int r = i / DN, c = (i % DN) * 8;
      const bool ok = q0 + r < Sq;
      const long off = ok ? (long)(q0 + r) * rs + c : 0;
      cp_async_16(smem_addr(Qst + r * SROW + c), qb + off, ok);
      cp_async_16(smem_addr(Qst + BQ * SROW + r * SROW + c), dob + off, ok);
    }
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool ok = q0 + i < Sq;
      cp_async_8(smem_addr(LDs + (n % NSTAGE) * BQ + i), ldb + (ok ? q0 + i : 0), ok);
    }
  };
  // exp2 form: q-hat = bf16(q * scale*log2(e)) in place, each thread on the
  // chunks its own copies of step n wrote (landed: visible to this thread)
  auto fold_q = [&](int n) {
    bf16* Qst = QdOs + (n % NSTAGE) * STAGE;
    for (int i = tid; i < BQ * DN; i += NTHREADS) {
      uint4* p = reinterpret_cast<uint4*>(Qst + i / DN * SROW + i % DN * 8);
      *p = bf16x8_times(*p, qscale);
    }
  };
  load_q(0);
  cp_async_commit();                                              // K, V and q tile 0

  // the key bias of this thread's rows g and g+8 in log2 units; keys past Sk
  // get -inf, so p = 0 there
  float bl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    bl[r] = key >= Sk ? -INFINITY : bias ? bias[(long)b * Sk + key] * kLog2e : 0.f;
  }

  cp_async_wait<0>();
  if (EXP2) fold_q(0);
  __syncthreads();
  uint32_t kf[1][KS][4], vf[1][KS][4];                            // this warp's K and V rows as A fragments
  load_q_fragments<1, KS, SROW>(kf, Ks, warp * 16, lane);
  load_q_fragments<1, KS, SROW>(vf, Vs, warp * 16, lane);

  float dkacc[1][DN][4], dvacc[1][DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[0][dn][e] = dvacc[0][dn][e] = 0.f;

  const int mq = warp / WPM, dn0 = warp % WPM * NDQ;
  for (int n = 0; n < nqt; ++n) {
    if (n > 0) {
      cp_async_wait<0>();                                         // q tile n has landed (this thread's part)
      if (EXP2) fold_q(n);
      __syncthreads();                                            // ... every thread's; tile n-1 and dS^T consumed
    }
    if (n + 1 < nqt) load_q(n + 1);                               // into the stage tile n-1 left
    cp_async_commit();
    const int q0 = tile_q0(n);
    const bf16* Qst = QdOs + (n % NSTAGE) * STAGE;
    const bf16* dOst = Qst + BQ * SROW;
    const float2* LDst = LDs + (n % NSTAGE) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: [16 keys x BQ q rows] per warp, fp32
    float s[1][NT][4], dp[1][NT][4];
    qk_product<1, KS, NT, SROW>(s, kf, Qst, lane);
    qk_product<1, KS, NT, SROW>(dp, vf, dOst, lane);

    // P^T and dS^T, rounded to bf16 in pairs: the A fragments over q
    uint32_t pa[KT][4], da[KT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 c = *reinterpret_cast<const float4*>(LDst + j * 8 + 2 * t);  // q columns 2t, 2t+1
#pragma unroll
      for (int r = 0; r < 2; ++r) {                               // key rows g, g+8
        const float p0 = exp2_approx(fmaf(s[0][j][2 * r], sl2, bl[r]) - c.x);
        const float p1 = exp2_approx(fmaf(s[0][j][2 * r + 1], sl2, bl[r]) - c.z);
        pa[j / 2][j % 2 * 2 + r] = pack_bf16(p0, p1);
        da[j / 2][j % 2 * 2 + r] = pack_bf16(p0 * (dp[0][j][2 * r] - c.y),
                                             p1 * (dp[0][j][2 * r + 1] - c.w));
      }
    }
    times_tile<KT, DN, SROW>(dvacc[0], pa, dOst, lane);           // dV += P^T dO
    times_tile<KT, DN, SROW>(dkacc[0], da, Qst, lane);            // dK += dS^T Q

    // dS^T into shared memory (this warp's 16 key rows), for dQ = dS K
    bf16* drow = dSs + (warp * 16 + g) * DSROW + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(drow + j * 8) = da[j / 2][j % 2 * 2];
      *reinterpret_cast<uint32_t*>(drow + 8 * DSROW + j * 8) = da[j / 2][j % 2 * 2 + 1];
    }
    __syncthreads();

    // dQ rows [16*mq, 16*mq + 16) of the tile, n8 columns [dn0, dn0 + NDQ),
    // over the block's BK keys: dS by ldmatrix.trans of dS^T, K's B fragments
    // by ldmatrix.trans of the K tile
    float acc[NDQ][4];
#pragma unroll
    for (int i = 0; i < NDQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, smem_addr(dSs + (kk * 16 + lane / 16 * 8 + lane % 8) * DSROW
                                     + mq * 16 + (lane / 8) % 2 * 8));
      const bf16* krow = Ks + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * SROW;
#pragma unroll
      for (int i = 0; i + 1 < NDQ; i += 2) {
        const int dn = dn0 + i;
        if (dn + 1 < DN) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, smem_addr(krow + dn * 8 + lane / 16 * 8));
          mma_bf16_16816(acc[i], a, bfr[0], bfr[1]);
          mma_bf16_16816(acc[i + 1], a, bfr[2], bfr[3]);
        } else if (dn < DN) {
          uint32_t bfr[2];
          ldmatrix_x2_trans(bfr, smem_addr(krow + dn * 8));
          mma_bf16_16816(acc[i], a, bfr[0], bfr[1]);
        }
      }
      if (NDQ % 2 && dn0 + NDQ - 1 < DN) {
        uint32_t bfr[2];
        ldmatrix_x2_trans(bfr, smem_addr(krow + (dn0 + NDQ - 1) * 8));
        mma_bf16_16816(acc[NDQ - 1], a, bfr[0], bfr[1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = q0 + mq * 16 + g + 8 * r;
      if (qrow < Sq) {
        float* dst = dqb + (long)qrow * rs + 2 * t;
#pragma unroll
        for (int i = 0; i < NDQ; ++i)
          if (dn0 + i < DN) add2_global(dst + (dn0 + i) * 8, acc[i][2 * r], acc[i][2 * r + 1]);
      }
    }
  }

  // epilogue: dK and dV through the warp's own rows of the K and V tiles
  // (free once every warp's last dQ product is done), 16-byte stores
  __syncthreads();
  const float fk[1][2] = {{dk_scale, dk_scale}}, fv[1][2] = {{1.f, 1.f}};
  store_rows<1, DN, SROW>(dk + koff, Ks, dkacc, fk, warp * 16, k0, Sk, rs, lane);
  store_rows<1, DN, SROW>(dv + koff, Vs, dvacc, fv, warp * 16, k0, Sk, rs, lane);
}

// One thread per (b, i, h) row: ld[b*H + h][i] = (lse * log2(e), rowsum(dO*O))
// in fp32, and the row of the dQ scratch zeroed.
__global__ void __launch_bounds__(AUX_THREADS)
flash_bwd_prepass_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, float2* __restrict__ ld,
                         float* __restrict__ dq_acc, int H, int Sq, int D, long rows) {
  const long r = (long)blockIdx.x * AUX_THREADS + threadIdx.x;    // (b*Sq + i)*H + h
  if (r >= rows) return;
  const uint4* o = reinterpret_cast<const uint4*>(out + r * D);
  const uint4* go = reinterpret_cast<const uint4*>(dout + r * D);
  float4* z = reinterpret_cast<float4*>(dq_acc + r * D);
  float delta = 0.f;
  for (int c = 0; c < D / 8; ++c) {
    const uint4 a = o[c], w = go[c];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(w2[i]);
      delta = fmaf(x.x, y.x, delta);
      delta = fmaf(x.y, y.y, delta);
    }
    z[2 * c] = z[2 * c + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int h = (int)(r % H);
  const long bi = r / H;                                          // b*Sq + i
  const long row = (bi / Sq * H + h) * Sq + bi % Sq;
  ld[row] = make_float2(lse[row] * kLog2e, delta);
}

// dq = bf16(dq_acc * scale), eight values a thread, 16-byte stores.
__global__ void __launch_bounds__(AUX_THREADS)
flash_bwd_dq_convert_kernel(const float4* __restrict__ acc, uint4* __restrict__ dq, long n8,
                            float scale) {
  const long i = (long)blockIdx.x * AUX_THREADS + threadIdx.x;
  if (i >= n8) return;
  const float4 a = acc[2 * i], c = acc[2 * i + 1];
  dq[i] = make_uint4(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale),
                     pack_bf16(c.x * scale, c.y * scale), pack_bf16(c.z * scale, c.w * scale));
}

template <int DN, bool EXP2>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* out, const void* dout, const void* lse, void* ld, void* dq_acc,
                   void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, float scale,
                   cudaStream_t stream) {
  using T = Tiles<DN>;
  constexpr int D = T::D;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<DN, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  const long rows = (long)B * Sq * H;
  flash_bwd_prepass_kernel<<<(unsigned)((rows + AUX_THREADS - 1) / AUX_THREADS), AUX_THREADS, 0,
                             stream>>>(static_cast<const bf16*>(out),
                                       static_cast<const bf16*>(dout),
                                       static_cast<const float*>(lse), static_cast<float2*>(ld),
                                       static_cast<float*>(dq_acc), H, Sq, D, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const float sl2 = scale * kLog2e;
  flash_bwd_kernel<DN, EXP2><<<dim3((Sk + T::BK - 1) / T::BK, B * H), T::NTHREADS, T::SMEM,
                               stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<const bf16*>(dout),
      static_cast<const float2*>(ld), static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Sq, Sk, EXP2 ? 1.f : sl2, sl2, EXP2 ? 1.f / kLog2e : scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long n8 = rows * DN;
  flash_bwd_dq_convert_kernel<<<(unsigned)((n8 + AUX_THREADS - 1) / AUX_THREADS), AUX_THREADS, 0,
                                stream>>>(static_cast<const float4*>(dq_acc),
                                          static_cast<uint4*>(dq), n8, scale);
  return cudaGetLastError();
}

// registers a thread, shared memory a block, keys a block, q rows a tile,
// resident blocks an SM, local (spill) memory a thread
template <int DN, bool EXP2>
cudaError_t describe(int* info) {
  using T = Tiles<DN>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<DN, EXP2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_bwd_kernel<DN, EXP2>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_bwd_kernel<DN, EXP2>,
                                                      T::NTHREADS, T::SMEM);
  info[0] = attr.numRegs;
  info[1] = (int)T::SMEM;
  info[2] = T::BK;
  info[3] = T::BQ;
  info[4] = blocks;
  info[5] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace

#define FLASH_BWD_DISPATCH(CALL)                                                              \
  switch (D / 8) {                                                                            \
    CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8)                          \
    CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)                   \
    default: return (int)cudaErrorInvalidValue;                                               \
  }

// Returns a cudaError_t code: 0 when the three launches were accepted. exp2
// != 0 selects the exp2 form. ld ([B*H, Sq] float2) and dq_acc ([B, Sq, H, D]
// f32) are scratch that the call fills itself: afterwards ld holds
// (lse*log2(e), delta) per row.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* out, const void* dout,
                                   const void* lse, void* ld, void* dq_acc, void* dq, void* dk,
                                   void* dv, int B, int Sq, int Sk, int H, int D, float scale,
                                   int exp2, void* stream) {
  if (D % 8 != 0 || D <= 0 || D > 128 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_LAUNCH(DN)                                                                  \
  case DN:                                                                                    \
    return (int)(exp2 ? launch<DN, true>(q, k, v, bias, out, dout, lse, ld, dq_acc, dq, dk,   \
                                         dv, B, Sq, Sk, H, scale, s)                          \
                      : launch<DN, false>(q, k, v, bias, out, dout, lse, ld, dq_acc, dq, dk,  \
                                          dv, B, Sq, Sk, H, scale, s));
  FLASH_BWD_DISPATCH(FLASH_BWD_LAUNCH)
#undef FLASH_BWD_LAUNCH
}

// The main kernel's resources at head dim D: info[0..5] = registers a thread,
// shared memory a block (bytes), keys a block, q rows a streamed tile,
// resident blocks an SM, local (spill) memory a thread (bytes).
extern "C" int flash_attention_bwd_describe(int D, int exp2, int* info) {
  if (D % 8 != 0 || D <= 0 || D > 128) return (int)cudaErrorInvalidValue;
#define FLASH_BWD_DESCRIBE(DN)                                                                \
  case DN:                                                                                    \
    return (int)(exp2 ? describe<DN, true>(info) : describe<DN, false>(info));
  FLASH_BWD_DISPATCH(FLASH_BWD_DESCRIBE)
#undef FLASH_BWD_DESCRIBE
}
