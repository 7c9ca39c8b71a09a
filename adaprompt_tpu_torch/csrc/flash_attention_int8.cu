// int8-QK flash attention forward for Hopper (sm_90a), forward only, no lse:
//   k_c      = bf16(k - bf16(mean over the keys of k))     per (batch, head)
//   q_q, q_s = quant_row(q);  k_q, k_s = quant_row(k_c)    per token
//   s        = (float(int32(q_q . k_q^T)) * (q_s*scale)) * k_s + key_bias
//   out      = softmax(s) . v   (fp32 online softmax, p rounded to bf16 for p.v)
// with quant_row as csrc/int8_rows.cuh states it (sc = max|x|/127 + 1e-8, a
// true division, rint, clip +-127). Softmax cannot see the key mean (a
// per-query constant), so centring only narrows K's int8 range.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fwd_kernel_i8 and
// the operand preparation that its wrapper flash_attention_int8 leaves to
// XLA (the key mean, the head folds, the two quantizations, K's transpose).
// Layouts are the bf16 flash forward's (csrc/flash_attention.cu): q/k/v
// [B, S, H, D] bf16, read in place with a row stride of H*D; key_bias [B, Sk]
// f32 or NULL; out [B, Sq, H, D] bf16. D is a multiple of 8, at most 128; Sq
// and Sk are any lengths. One workspace (flash_attention_int8_workspace
// bytes) takes what the call makes on the card.
//
// What bounds it: per score 2*D int8 operations (q.k^T) and 2*D bf16 flops
// (p.v), which at D=40 come to ~0.02 SM cycles on the tensor cores, against
// 1/16 SM cycle for its exponential: as in the bf16 kernel the exponentials
// bind, then the softmax's other instructions, which compete with them for
// dispatch. Bytes are small (q, k, v, out once; K is read twice by the key
// pass and its int8 rows once per query tile from L2).
//
// Design: one C call, three launches on the stream.
// - The key pass, two kernels over (key chunk, b*h): flash_int8_key_sum_kernel
//   sums each 256-key chunk in fp32 into a partial [B*H][chunks][D];
//   flash_int8_key_quant_kernel (a programmatic dependent launch) adds a head's
//   partials in a fixed order (no atomics: two calls give equal bits), rounds
//   the mean to bf16 as PyTorch's bf16 mean does (the fp32 sum times fp32(1/Sk),
//   rounded), then centres and quantizes its keys, a thread a 16-byte unit:
//   k_q [B*H][Sk][DQ] int8, one row per key, zero in columns [D, DQ), and k_s
//   [B*H][Sk]. Grids of hundreds of blocks keep the loads in flight where one
//   block per (b, h) left 100 SMs idle (tools/flash_int8_tiles.py: 0.1165
//   against 0.0221 ms at D=40 S=4096 B=4), and the quantization's divisions
//   are spread over all of a block's lanes.
// - The attention kernel, flash_fwd_int8_kernel: the bf16 forward B1's
//   structure on the helpers of csrc/flash_sm90.cuh. A block of four warps
//   owns 128 query rows of one (b, h) (64 above D = 80), a warp 16*MT rows for
//   the whole key loop. Its prologue stages q by cp.async, and a thread a row
//   takes the row's max, its scale and its int8 row (columns [D, DQ) zero);
//   Q's int8 A fragments are then loaded by ldmatrix (an 8x8 b16 matrix is 8
//   rows of 16 int8 values, exactly the s8 fragment) and stay in registers.
//   64-key tiles of int8 K rows, k_s, bf16 V rows and the key bias flow
//   through a ring of cp.async stages (three at DQ <= 64, two above) with one
//   block barrier a tile. S = Q.K^T runs on mma.sync.m16n8k32.s8 over DQ = D
//   rounded up to 16 (40 -> 48, 80 -> 80), the last step m16n8k16 where DQ %
//   32 == 16. The int32 C fragments have the fp32 ones' layout: each score is
//   dequantized in registers, each multiply rounded on its own as the plain
//   version rounds, then B1's steps run unchanged (key bias, ragged-edge mask,
//   online softmax in registers, P.V from the score registers, the epilogue).
//   No score or P touches shared memory; int8 rows have a stride of an odd
//   number of 16-byte units (48 B at D=40, 80 B at D=80), so ldmatrix reads
//   them without bank conflicts.
// - Each int32 sum becomes a float by I2F (exact: |q_q.k_q| <= 127^2 * 128 <
//   2^24). The dequantization's I2F and two multiplies a score are what this
//   kernel does beyond B1's softmax; they cost more than the int8 q.k^T saves,
//   so the attention kernel takes 1.05-1.07x B1's time at D=40 S=4096 B=4
//   (NVIDIA H100, 700 W).
// Not kept (tools/flash_int8_tiles.py on the card, D=40 S=4096 B=4): sums
// started at the bits of 1.5*2^23 and read by one FADD (variant "magic", 1-3 %
// slower); O rescaled only where a warp's row max moved (ptxas then took 200
// registers against 243: 5 % slower); two ring stages at D=40 (168 registers,
// 3 blocks an SM, 32 B of local memory: no faster, slower at S=2048); 64-row
// query tiles ("mt1", 10-13 % slower); Q's levels by a reciprocal with the
// true division only near a tie (the kernel then compiled to 182 registers and
// ran 17 % slower); one key-pass block per (b, h) (0.1165 ms against 0.0221).
// Masked keys carry a finite NEG_BIG bias: a row whose keys are all masked
// gets equal weights (the mean of v), as the plain softmax gives.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_sm90.cuh"
#include "int8_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash_sm90;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BK = 64;                    // keys a tile of the attention kernel
constexpr int KP_THREADS = 256;           // threads a block of the key pass
constexpr int KCH = 256;                  // keys a block of the key sums

// int32 sums start at kAccInit; sum_as_float gives each one's exact value
constexpr int kAccInit = 0;
__device__ __forceinline__ float sum_as_float(int acc) {
  return __int2float_rn(acc);
}

// d += a . b: [16x16] s8 x [16x8] s8 -> [16x8] s32 (a0 row g, a1 row g+8, each
// k 4t..4t+3; b0 k 4t..4t+3 of column g), the k16 tail of an int8 product
__device__ __forceinline__ void mma_s8_16816(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
               "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a0), "r"(a1), "r"(b0));
}

// Tile shapes and shared-memory layout for a head dim of D = 8*DN.
template <int DN>
struct Tiles {
  static constexpr int D = 8 * DN;
  static constexpr int DQ = (D + 15) / 16 * 16;           // depth of Q.K^T, bytes of an int8 row
  static constexpr int KS = DQ / 32;                      // its k32 steps ...
  static constexpr bool K16 = DQ % 32 != 0;               // ... and a k16 one
  static constexpr int KROW = DQ / 16 % 2 ? DQ : DQ + 16; // int8 row stride: odd 16-byte units
  static constexpr int SROW = padded_row(DQ);             // bf16 row stride (q, V, out staging)
  static constexpr int MT = DQ <= 80 ? 2 : 1;             // m16 row tiles a warp
  static constexpr int BQ = 16 * MT * NWARPS;             // query rows a block
  static constexpr int NSTAGE = DQ <= 64 ? 3 : 2;         // stages of the ring
  // byte offsets of the regions
  static constexpr int QB = 0;                            // q, then out staging [BQ][SROW] bf16
  static constexpr int Q8 = QB + BQ * SROW * 2;           // q_q [BQ][KROW] int8
  static constexpr int KR = Q8 + BQ * KROW;               // k_q [NSTAGE][BK][KROW] int8
  static constexpr int VR = KR + NSTAGE * BK * KROW;      // v [NSTAGE][BK][SROW] bf16
  static constexpr int KSR = VR + NSTAGE * BK * SROW * 2; // k_s [NSTAGE][BK] f32
  static constexpr int BR = KSR + NSTAGE * BK * 4;        // key bias [NSTAGE][BK] f32
  static constexpr int QSS = BR + NSTAGE * BK * 4;        // q_s * scale [BQ] f32
  static constexpr int SMEM = QSS + BQ * 4;
};

// eight bf16 values minus the bf16 mean of their columns, each rounded to bf16
__device__ __forceinline__ uint4 centre8(uint4 v, const bf16* mean) {
  const uint4 m = *reinterpret_cast<const uint4*>(mean);
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
  const __nv_bfloat162* f = reinterpret_cast<const __nv_bfloat162*>(&m);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(e[i]), b = __bfloat1622float2(f[i]);
    e[i] = __floats2bfloat162_rn(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
  }
  return v;
}

__device__ __forceinline__ void add8(float (&a)[8], const uint4& v) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(x2[i]);
    a[2 * i] += x.x;
    a[2 * i + 1] += x.y;
  }
}

// part[bh][chunk][:] = the fp32 sum of K over the chunk's keys; grid (chunks,
// B*H). Thread (rp, u) sums 16-byte unit u of keys rp, rp + RP, ..., all its
// loads in flight at once; the RP row partials are then added in a fixed
// order, in G column groups and then across the groups.
template <int DN>
__global__ void __launch_bounds__(KP_THREADS)
flash_int8_key_sum_kernel(const bf16* __restrict__ k, float* __restrict__ part, int H, int Sk) {
  constexpr int D = 8 * DN, RP = KP_THREADS / DN, RK = (KCH + RP - 1) / RP;
  constexpr int G = KP_THREADS / D;
  __shared__ float rows_s[RP * D];
  __shared__ float group_s[G * D];
  const int chunk = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, u = tid % DN, rp = tid / DN;
  const long rs = (long)H * D;
  const int k0 = chunk * KCH, k1 = min(Sk, k0 + KCH);
  if (rp < RP) {
    const bf16* kb = k + (long)b * Sk * rs + (long)h * D + u * 8;
    uint4 x[RK];
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int r = k0 + rp + j * RP;
      x[j] = r < k1 ? *reinterpret_cast<const uint4*>(kb + (long)r * rs) : make_uint4(0, 0, 0, 0);
    }
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < RK; ++j) add8(a, x[j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) rows_s[rp * D + u * 8 + i] = a[i];
  }
  __syncthreads();
  if (tid < G * D) {
    float sum = 0.f;
    for (int p = tid / D; p < RP; p += G) sum += rows_s[p * D + tid % D];
    group_s[tid] = sum;
  }
  __syncthreads();
  for (int c = tid; c < D; c += KP_THREADS) {
    float sum = 0.f;
    for (int gi = 0; gi < G; ++gi) sum += group_s[gi * D + c];
    part[((long)bh * gridDim.x + chunk) * D + c] = sum;
  }
}

// The key mean of (b, h) from its nch partials, then QROWS keys centred and
// quantized: kq [B*H][Sk][DQ] (columns [D, DQ) zero), ks [B*H][Sk]; the first
// block of each (b, h) also writes the mean, kmean [B*H][D] bf16. Grid
// (ceil(Sk / QROWS), B*H). A thread takes one 16-byte unit of a key in each
// of RR passes, all its loads issued before the wait for the partials; the
// lanes of a key exchange their maxima through shared memory. The partials
// are read by G groups of columns at once and added in a fixed order.
template <int DN>
struct KeyQuant {
  static constexpr int RR = 4;                                    // passes
  static constexpr int QR = KP_THREADS / DN;                      // keys a pass
  static constexpr int QROWS = RR * QR;                           // keys a block
};

template <int DN>
__global__ void __launch_bounds__(KP_THREADS)
flash_int8_key_quant_kernel(const bf16* __restrict__ k, const float* __restrict__ part, int nch,
                            int8_t* __restrict__ kq, float* __restrict__ ks,
                            bf16* __restrict__ kmean, int H, int Sk, float inv_sk) {
  using Q = KeyQuant<DN>;
  constexpr int D = 8 * DN, DQ = Tiles<DN>::DQ, RR = Q::RR, QR = Q::QR;
  constexpr int G = KP_THREADS / D;                               // column groups of the mean
  __shared__ float group_s[G * D];
  __shared__ float umax_s[RR * QR * DN];                          // each unit's max|k_c|
  __shared__ __align__(16) bf16 mean_s[D];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, rr = tid / DN, u = tid % DN;
  const long rs = (long)H * D;
  const bool lane_ok = rr < QR;
  uint4 x[RR];
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    const int r = blockIdx.x * Q::QROWS + j * QR + rr;
    x[j] = lane_ok && r < Sk
               ? *reinterpret_cast<const uint4*>(k + ((long)b * Sk + r) * rs + (long)h * D + u * 8)
               : make_uint4(0, 0, 0, 0);
  }
  int8_rows::wait_for_predecessor();                             // part, and the last call's reads
  if (tid < G * D) {
    float sum = 0.f;
#pragma unroll 4
    for (int p = tid / D; p < nch; p += G) sum += part[((long)bh * nch + p) * D + tid % D];
    group_s[tid] = sum;
  }
  __syncthreads();
  for (int c = tid; c < D; c += KP_THREADS) {
    float sum = 0.f;
    for (int gi = 0; gi < G; ++gi) sum += group_s[gi * D + c];
    const bf16 m = __float2bfloat16_rn(__fmul_rn(sum, inv_sk));
    mean_s[c] = m;
    if (blockIdx.x == 0) kmean[(long)bh * D + c] = m;
  }
  __syncthreads();
  if (lane_ok) {
#pragma unroll
    for (int j = 0; j < RR; ++j) {
      x[j] = centre8(x[j], mean_s + u * 8);
      umax_s[(j * QR + rr) * DN + u] = int8_rows::absmax8(x[j], 0.f);
    }
  }
  __syncthreads();
  if (!lane_ok) return;
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    const int r = blockIdx.x * Q::QROWS + j * QR + rr;
    if (r >= Sk) break;
    const float* um = umax_s + (j * QR + rr) * DN;
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < DN; ++i) mx = fmaxf(mx, um[i]);
    const float sc = int8_rows::row_scale(mx);
    uint2* dst = reinterpret_cast<uint2*>(kq + ((long)bh * Sk + r) * DQ);
    dst[u] = int8_rows::quantize8(x[j], sc);
    if (DN % 2 && u == DN - 1) dst[DN] = make_uint2(0u, 0u);      // the pad columns [D, DQ)
    if (u == 0) ks[(long)bh * Sk + r] = sc;
  }
}

template <int DN>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_int8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ kq,
                      const float* __restrict__ ks, const bf16* __restrict__ v,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      int8_t* __restrict__ qq_keep, float* __restrict__ qs_keep,
                      int H, int Sq, int Sk, float scale) {
  using T = Tiles<DN>;
  constexpr int DQ = T::DQ, KS = T::KS, KROW = T::KROW, SROW = T::SROW, MT = T::MT,
                BQ = T::BQ, NSTAGE = T::NSTAGE;
  constexpr int NT = BK / 8;                                      // n8 score tiles a key tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qb = reinterpret_cast<bf16*>(smem + T::QB);
  int8_t* Q8 = reinterpret_cast<int8_t*>(smem + T::Q8);
  float* qss_s = reinterpret_cast<float*>(smem + T::QSS);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                           // fragment row and column pair
  const long rs = (long)H * T::D;                                 // elements per sequence position
  const bf16* qb = q + (long)b * Sq * rs + (long)h * T::D;
  const bf16* vb = v + (long)b * Sk * rs + (long)h * T::D;
  const int8_t* kqb = kq + (long)bh * Sk * DQ;
  const float* ksb = ks + (long)bh * Sk;
  const float* biasb = bias ? bias + (long)b * Sk : nullptr;
  const int ntiles = (Sk + BK - 1) / BK;

  // the q tile -> Qb, its own cp.async group, the first (rows past Sq zero)
  for (int i = tid; i < BQ * DN; i += NTHREADS) {
    const int r = i / DN, c = (i % DN) * 8;
    const bool ok = q0 + r < Sq;
    cp_async_16(smem_addr(Qb + r * SROW + c), qb + (ok ? (long)(q0 + r) * rs + c : 0), ok);
  }
  cp_async_commit();

  // key tile n -> stage n % NSTAGE: int8 K rows, k_s, V and the bias; keys
  // past Sk are zero-filled, not read
  auto load_kv = [&](int n) {
    const int st = n % NSTAGE, k0 = n * BK;
    int8_t* Kst = reinterpret_cast<int8_t*>(smem + T::KR) + st * BK * KROW;
    bf16* Vst = reinterpret_cast<bf16*>(smem + T::VR) + st * BK * SROW;
    for (int i = tid; i < BK * (DQ / 16); i += NTHREADS) {
      const int r = i / (DQ / 16), c = (i % (DQ / 16)) * 16;
      const bool ok = k0 + r < Sk;
      cp_async_16(smem_addr(Kst + r * KROW + c), kqb + (ok ? (long)(k0 + r) * DQ + c : 0), ok);
    }
    for (int i = tid; i < BK * DN; i += NTHREADS) {
      const int r = i / DN, c = (i % DN) * 8;
      const bool ok = k0 + r < Sk;
      cp_async_16(smem_addr(Vst + r * SROW + c), vb + (ok ? (long)(k0 + r) * rs + c : 0), ok);
    }
    if (tid < BK) {
      const bool ok = k0 + tid < Sk;
      cp_async_4(smem_addr(reinterpret_cast<float*>(smem + T::KSR) + st * BK + tid),
                 ksb + (ok ? k0 + tid : 0), ok);
    } else if (biasb && tid < 2 * BK) {
      const int i = tid - BK;
      const bool ok = k0 + i < Sk;
      cp_async_4(smem_addr(reinterpret_cast<float*>(smem + T::BR) + st * BK + i),
                 biasb + (ok ? k0 + i : 0), ok);
    }
  };
  int8_rows::wait_for_predecessor();                             // k_q and k_s: the key pass
#pragma unroll
  for (int n = 0; n < NSTAGE - 1; ++n) {
    if (n < ntiles) load_kv(n);
    cp_async_commit();                                            // one group per tile, empty or not
  }

  // the q tile quantized, a thread a row: q_q -> Q8, q_s * scale -> qss_s
  cp_async_wait<NSTAGE - 1>();                                    // the q group has landed
  __syncthreads();
  for (int r = tid; r < BQ; r += NTHREADS) {
    const uint4* src = reinterpret_cast<const uint4*>(Qb + r * SROW);
    float mx = 0.f;
#pragma unroll
    for (int u = 0; u < DN; ++u) mx = int8_rows::absmax8(src[u], mx);
    const float sc = int8_rows::row_scale(mx);
    uint2* dst = reinterpret_cast<uint2*>(Q8 + r * KROW);
#pragma unroll
    for (int u = 0; u < DN; ++u) dst[u] = int8_rows::quantize8(src[u], sc);
    if (DN % 2) dst[DN] = make_uint2(0u, 0u);                     // the pad columns [D, DQ)
    qss_s[r] = __fmul_rn(sc, scale);
    if (qq_keep && q0 + r < Sq) {                                 // kept for a test of the operands
      uint2* keep = reinterpret_cast<uint2*>(qq_keep + ((long)bh * Sq + q0 + r) * DQ);
#pragma unroll
      for (int u = 0; u < DQ / 8; ++u) keep[u] = dst[u];
      qs_keep[(long)bh * Sq + q0 + r] = sc;
    }
  }
  __syncthreads();

  // Q's int8 A fragments, for the whole loop: k32 steps by the bf16 A
  // addressing counted in bytes, the k16 tail (a0, a1 of each m16 tile) by one
  // x4 load over the warp's rows
  const int row0 = warp * 16 * MT;                                // this warp's first row of the tile
  uint32_t qf[MT][KS > 0 ? KS : 1][4];
  uint32_t qt[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[mt][kk], smem_addr(Q8 + (row0 + mt * 16 + lane % 8 + (lane / 8) % 2 * 8) * KROW
                                        + kk * 32 + lane / 16 * 16));
  if (T::K16) {
    uint32_t r4[4];
    ldmatrix_x4(r4, smem_addr(Q8 + (row0 + (MT == 2 ? lane : lane % 16)) * KROW + KS * 32));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      qt[mt][0] = r4[2 * mt];
      qt[mt][1] = r4[2 * mt + 1];
    }
  }
  float qsc[MT][2];                                               // q_s * scale of rows g, g+8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) qsc[mt][r] = qss_s[row0 + mt * 16 + g + 8 * r];

  // With a key bias, scores are biased in the log2 domain before the max
  // (s*log2(e) + bias*log2(e), exponent factor 1); without one the max is
  // taken on s and log2(e) folds into the exponent's multiply-add.
  const float sc = biasb ? 1.f : kLog2e;
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
    const int st = n % NSTAGE, k0 = n * BK;
    const int8_t* Kst = reinterpret_cast<const int8_t*>(smem + T::KR) + st * BK * KROW;
    const bf16* Vst = reinterpret_cast<const bf16*>(smem + T::VR) + st * BK * SROW;
    const float* Kss = reinterpret_cast<const float*>(smem + T::KSR) + st * BK;

    // S = Q_q K_q^T on the int8 tensor cores: [16*MT x 64] int32 a warp
    int acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = kAccInit;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t kf[4];                                           // b0, b1 of n8 tiles 2*j2, 2*j2+1
        ldmatrix_x4(kf, smem_addr(Kst + (j2 * 16 + lane % 8 + lane / 16 * 8) * KROW
                                  + kk * 32 + (lane / 8) % 2 * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          block_gemm::mma_s8_16832(acc[mt][2 * j2], qf[mt][kk], kf[0], kf[1]);
          block_gemm::mma_s8_16832(acc[mt][2 * j2 + 1], qf[mt][kk], kf[2], kf[3]);
        }
      }
    }
    if (T::K16) {
#pragma unroll
      for (int j4 = 0; j4 < NT / 4; ++j4) {
        uint32_t kf[4];                                           // b0 of n8 tiles 4*j4 .. 4*j4+3
        ldmatrix_x4(kf, smem_addr(Kst + (j4 * 32 + lane) * KROW + KS * 32));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_s8_16816(acc[mt][4 * j4 + i], qt[mt][0], qt[mt][1], kf[i]);
      }
    }

    // dequantized in registers: (sum * (q_s*scale)) * k_s, each rounded
    float s[MT][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 k2 = *reinterpret_cast<const float2*>(Kss + j * 8 + 2 * t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][j][e] = __fmul_rn(__fmul_rn(sum_as_float(acc[mt][j][e]), qsc[mt][e / 2]),
                                  e % 2 ? k2.y : k2.x);
    }
    if (biasb)
      add_key_bias<MT, NT>(s, reinterpret_cast<const float*>(smem + T::BR) + st * BK, kLog2e, t);
    if (k0 + BK > Sk) mask_keys_past<MT, NT>(s, k0, Sk, t);      // the ragged last tile

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
    pv_product<MT, NT, DN, SROW>(o, s, Vst, lane);
  }

  // epilogue: O/l through the warp's own rows of the q staging tile
  float inv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[mt][r] = 1.f / quad_sum(l[mt][r]);
  store_rows<MT, DN, SROW>(out + (long)b * Sq * rs + (long)h * T::D, Qb, o, inv, row0, q0, Sq, rs,
                           lane);
}

// The scratch carved out of the caller's workspace, byte offsets (256-aligned)
struct Workspace {
  size_t kq, ks, kmean, part, qq, qs, total;
  Workspace(int B, int Sq, int Sk, int H, int D) {
    const size_t bh = (size_t)B * H, dq = (D + 15) / 16 * 16, nch = (Sk + KCH - 1) / KCH;
    size_t off = 0;
    auto take = [&off](size_t bytes) {
      const size_t at = off;
      off += (bytes + 255) / 256 * 256;
      return at;
    };
    kq = take(bh * Sk * dq);                  // k_q [B*H][Sk][DQ] int8
    ks = take(bh * Sk * 4);                   // k_s [B*H][Sk] f32
    kmean = take(bh * D * 2);                 // the key mean [B*H][D] bf16
    part = take(bh * nch * D * 4);            // partial key sums [B*H][chunks][D] f32
    qq = take((size_t)B * Sq * H * dq);       // q_q [B*H][Sq][DQ] int8, kept on request
    qs = take((size_t)B * Sq * H * 4);        // q_s [B*H][Sq] f32, kept on request
    total = off;
  }
};

template <int DN>
cudaError_t smem_attribute() {
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_int8_kernel<DN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<DN>::SMEM);
  return err;
}

// The key pass: partial sums, then the mean and k_q, k_s
template <int DN>
cudaError_t launch_keys(const bf16* k, unsigned char* ws, const Workspace& W, int B, int Sk, int H,
                        cudaStream_t s) {
  const int nch = (Sk + KCH - 1) / KCH;
  flash_int8_key_sum_kernel<DN><<<dim3(nch, B * H), KP_THREADS, 0, s>>>(
      k, reinterpret_cast<float*>(ws + W.part), H, Sk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int QROWS = KeyQuant<DN>::QROWS;
  return int8_rows::launch_after(flash_int8_key_quant_kernel<DN>,
                                 dim3((Sk + QROWS - 1) / QROWS, B * H), KP_THREADS, 0, s, k,
                                 reinterpret_cast<const float*>(ws + W.part), nch,
                                 reinterpret_cast<int8_t*>(ws + W.kq),
                                 reinterpret_cast<float*>(ws + W.ks),
                                 reinterpret_cast<bf16*>(ws + W.kmean), H, Sk, 1.f / (float)Sk);
}

template <int DN>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   void* workspace, int B, int Sq, int Sk, int H, float scale, bool keep_q,
                   cudaStream_t s) {
  using T = Tiles<DN>;
  cudaError_t err = smem_attribute<DN>();
  if (err != cudaSuccess) return err;
  const Workspace W(B, Sq, Sk, H, T::D);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  err = launch_keys<DN>(static_cast<const bf16*>(k), ws, W, B, Sk, H, s);
  if (err != cudaSuccess) return err;
  return int8_rows::launch_after(
      flash_fwd_int8_kernel<DN>, dim3((Sq + T::BQ - 1) / T::BQ, B * H), NTHREADS, T::SMEM, s,
      static_cast<const bf16*>(q), reinterpret_cast<const int8_t*>(ws + W.kq),
      reinterpret_cast<const float*>(ws + W.ks), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out),
      keep_q ? reinterpret_cast<int8_t*>(ws + W.qq) : nullptr,
      keep_q ? reinterpret_cast<float*>(ws + W.qs) : nullptr, H, Sq, Sk, scale);
}

// info[0..4]: registers a thread, shared memory a block (bytes), rows a block,
// resident blocks an SM, local memory a thread (bytes)
template <class Kernel>
cudaError_t describe_one(Kernel kernel, int threads, int dyn_smem, int rows, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn_smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes + dyn_smem;
  info[2] = rows;
  info[3] = blocks;
  info[4] = (int)attr.localSizeBytes;
  return err;
}

template <int DN>
cudaError_t describe(int* info) {
  using T = Tiles<DN>;
  cudaError_t err = smem_attribute<DN>();
  if (err == cudaSuccess)
    err = describe_one(flash_int8_key_sum_kernel<DN>, KP_THREADS, 0, KCH, info);
  if (err == cudaSuccess)
    err = describe_one(flash_int8_key_quant_kernel<DN>, KP_THREADS, 0, KeyQuant<DN>::QROWS,
                       info + 5);
  if (err == cudaSuccess)
    err = describe_one(flash_fwd_int8_kernel<DN>, NTHREADS, T::SMEM, T::BQ, info + 10);
  return err;
}

bool shapes_ok(int B, int Sq, int Sk, int H, int D) {
  return D % 8 == 0 && D > 0 && D <= 128 && B > 0 && Sq > 0 && Sk > 0 && H > 0;
}

}  // namespace

#define FLASH_I8_DISPATCH(CALL)                                                               \
  switch (D / 8) {                                                                            \
    CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8)                          \
    CALL(9) CALL(10) CALL(11) CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)                   \
    default: return (int)cudaErrorInvalidValue;                                               \
  }

// The workspace flash_attention_int8_fwd takes at these shapes: layout[0] its
// bytes, layout[1..6] the byte offsets of k_q [B*H][Sk][DQ] int8, k_s
// [B*H][Sk] f32, the key mean [B*H][D] bf16, the partial key sums, q_q
// [B*H][Sq][DQ] int8 and q_s [B*H][Sq] f32 (DQ = D rounded up to 16; q_q and
// q_s are written only by a call with keep_q).
extern "C" int flash_attention_int8_workspace(int B, int Sq, int Sk, int H, int D,
                                              long long* layout) {
  if (!shapes_ok(B, Sq, Sk, H, D)) return (int)cudaErrorInvalidValue;
  const Workspace W(B, Sq, Sk, H, D);
  const size_t at[7] = {W.total, W.kq, W.ks, W.kmean, W.part, W.qq, W.qs};
  for (int i = 0; i < 7; ++i) layout[i] = (long long)at[i];
  return 0;
}

// Returns a cudaError_t code: 0 when the three launches were accepted. They
// run on `stream` back to back: the key pass's two kernels, then the
// attention kernel; `workspace` holds flash_attention_int8_workspace bytes,
// 256-byte aligned. keep_q != 0 also keeps the kernel's q_q and q_s there.
extern "C" int flash_attention_int8_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, void* out, void* workspace, int B,
                                        int Sq, int Sk, int H, int D, float scale, int keep_q,
                                        void* stream) {
  if (!shapes_ok(B, Sq, Sk, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_I8_LAUNCH(DN)                                                                   \
  case DN:                                                                                    \
    return (int)launch<DN>(q, k, v, bias, out, workspace, B, Sq, Sk, H, scale, keep_q != 0, s);
  FLASH_I8_DISPATCH(FLASH_I8_LAUNCH)
#undef FLASH_I8_LAUNCH
}

// The key pass alone (its two kernels), into the workspace of a call at these
// shapes: k_q, k_s and the key mean.
extern "C" int flash_attention_int8_keys(const void* k, void* workspace, int B, int Sq, int Sk,
                                         int H, int D, void* stream) {
  if (!shapes_ok(B, Sq, Sk, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace W(B, Sq, Sk, H, D);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
#define FLASH_I8_KEYS(DN)                                                                     \
  case DN:                                                                                    \
    return (int)launch_keys<DN>(static_cast<const bf16*>(k), ws, W, B, Sk, H, s);
  FLASH_I8_DISPATCH(FLASH_I8_KEYS)
#undef FLASH_I8_KEYS
}

// The three kernels' resources at head dim D, in launch order (key sums, key
// quantization, attention): info[5k..5k+4] = registers a thread, shared
// memory a block (bytes), rows a block (keys for the key pass, query rows for
// the attention kernel), resident blocks an SM, local memory a thread (bytes).
extern "C" int flash_attention_int8_describe(int D, int* info) {
  if (!shapes_ok(1, 1, 1, 1, D)) return (int)cudaErrorInvalidValue;
#define FLASH_I8_DESCRIBE(DN)                                                                 \
  case DN:                                                                                    \
    return (int)describe<DN>(info);
  FLASH_I8_DISPATCH(FLASH_I8_DESCRIBE)
#undef FLASH_I8_DESCRIBE
}
