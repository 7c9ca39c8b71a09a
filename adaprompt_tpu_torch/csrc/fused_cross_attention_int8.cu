// w8a8 fused cross-attention for Hopper (sm_90a), forward only, as four
// kernels in one C call:
//   x_q, xs = quant_row(x);  q = bf16(int(x_q . Wq_q^T) * xs * sq)
//   per head h: p_h = bf16(softmax(q_h . k_h^T * scale));  o_h = p_h . v_h  (fp32)
//   o = concat_h(o_h) in fp32;  o_q, os = quant_row(o)
//   out = bf16(int(o_q . Wo_q^T) * os * so + bo)
// with quant_row(v) = (clip(rint(v / sc), -127, 127), sc = max|v| / 127 + 1e-8)
// per row over all C columns, rounding half to even from the fp32 value, as
// jnp.round does.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fused_cross_i8_kernel
// (launched from fused_cross_attention_int8). Layouts: x [B, N, C] bf16;
// Wq_q, Wo_q [C, C] int8 in PyTorch's [out, in] layout with per-output-
// channel scales sq, so [C] f32 (quant.quantize_weight); k/v [B, S, H, hd]
// bf16 as unet.precompute_cross_kv returns them (read with strides); bo [C]
// f32; out [B, N, C] bf16.
//
// What bounds it: the two C x C projections, 4*N*C^2 int8 operations per
// batch row, and the attention over S = 77 keys, 4*N*S*C bf16 flops, against
// x in and out (4*N*C bytes per batch row) besides the int8 weights and the
// tiny K/V: at C=320 the bytes bound it, at C=640 the operations, both near
// the card's ridge. The split below adds x_q's, o's fp32 and o_q's round
// trips (~53 MB at C=320 N=4096 B=4, ~0.016 ms at the rate of device memory,
// partly served from the 50 MB L2): that is what the split costs.
//
// Why it splits where it does. The TPU kernel keeps a row tile's q and its
// fp32 head concat in VMEM and walks the heads in turn; on this card that
// form holds [rows, C] tiles of q and of fp32 o in shared memory, caps the
// row tile at 16-32 rows and makes every block re-read both weights. Both
// packages take a maximum over all C columns twice, for x's scale and for
// o's, so the call is split at those two points, as the bf16 kernel
// (csrc/fused_cross_attention.cu) is split at o's rounding and the int8
// GEGLU (csrc/geglu_int8.cu) at g's quantization:
//   * cross_int8_quant_x_kernel<L>: x_q [B*N, C] int8 and xs [B*N], L
//     lanes a row (int8_rows.cuh, B6's x pass; L = 8 at C=320, 16 at C=640,
//     so that a warp's 32 lanes have as many loads in flight as at C=1280);
//   * cross_int8_q_attn_kernel, grid (head, row tile, batch row): the bf16
//     kernel's q-attention kernel with its main loop on BlockGemmS8
//     (block_gemm.cuh: a cp.async ring 128 bytes deep in K, ldmatrix,
//     mma.sync.m16n8k32 s8 x s8 -> s32). A tile of BM rows x hdp =
//     round_up(hd, 16) columns of x_q . Wq_q_h^T (K = C), 4 warps of 16*MT
//     rows; the rows hd..hdp-1 of its Wq tile are zero-filled, never head
//     h+1's, so q's padded columns are exact zeros. K_h and V_h of the
//     block's batch row (77 keys, padded to 80 with zeros) go to their own
//     shared memory by cp.async before the main loop. The epilogue keeps each
//     warp's rows in registers: the int32 sums are dequantized, rounded to
//     bf16 in pairs, and are then the A fragments of S = q_h . K_h^T over all
//     80 keys (m16n8k32's s32 C fragment has m16n8k16's fp32 C layout); an
//     exact one-tile softmax (the padded keys -inf, quad reductions, expf as
//     the plain version's exp); P normalized, rounded to bf16 and fed
//     from the registers to O_h = P . V_h (V by ldmatrix.trans). O_h is not
//     rounded: it goes to an fp32 o [B*N, C] at columns [h*hd, (h+1)*hd), and
//     each row's max|O_h| (a quad reduction; the padded columns are zeros) to
//     pmax [B*N, H];
//   * cross_int8_quant_o_kernel<L>: os from a row's H partial maxima, then
//     o_q [B*N, C] int8 from o read in 16-byte units, L lanes a row (B6's g
//     pass with H partials);
//   * cross_int8_out_kernel<Out|OutThin>: out = o_q . Wo_q^T (K = C),
//     dequantized, + bo, rounded to bf16, staged in the ring's shared memory
//     and stored in 16-byte row pieces (B6's out kernel); a 128 x 160 tile,
//     one block an SM, or 64 x 160, two an SM, where the 128-row grid would
//     leave more than half the SMs idle (C=640 at batch 2).
// The heads' blocks of one row tile are neighbours in launch order, as are
// the column tiles of the out kernel's row tile, so x_q and o_q are re-read
// from L2. The last three kernels are programmatic dependents of the one
// before (int8_rows.cuh's launch_after).
//
// Exactness. The int32 sums are exact; the scales are true divisions and the
// dequantizations are rounded step by step (int8_rows.cuh), so from the same
// input x_q, xs and q equal the plain version's bit for bit. After q the sums
// run in another order than einsum's, so o's fp32 values may differ in the
// last bits and a level of o_q near a tie may flip (bounded by 2e-2 *
// max|out|). The
// scales and maxima need no zeroing between calls. Limits: C % 16 == 0, S <=
// 80 keys, hd <= 160 (the wrapper refuses others by name); head dims not a
// multiple of 8 take 2-byte K/V loads and o's columns 4 bytes at a time.
// The wrapper gives one workspace (fused_cross_int8_workspace bytes) for
// x_q, xs, o, pmax, o_q and os.
//
// Left for later: quantizing o inside the out kernel's staging (one fp32
// read of o, no o_q round trip), wgmma with TMA, and a persistent grid over
// (head, row tile).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "flash_sm90.cuh"
#include "int8_rows.cuh"

namespace {

using namespace block_gemm;
using namespace flash_sm90;
using namespace int8_rows;
using bf16 = __nv_bfloat16;

constexpr int SKP = 80;                  // keys a block holds: S padded to 10 n8 tiles
constexpr int NKT = SKP / 8;
// The row passes give a row the fewest of MIN_ROW_LANES, ..., 32 lanes whose
// XU units each cover it (8 lanes at C=320, 16 at C=640)
constexpr int MIN_ROW_LANES = 8;

// The q-attention kernel's tile at padded head dim HDP: 4 warps of 16*MT
// rows, each over all HDP columns; the ring rows are 128 int8 values deep.
template <int HDP>
struct QAttn {
  static constexpr int MT = HDP <= 80 ? 2 : 1;
  using Gemm = BlockGemmS8<64 * MT, HDP, 128, 4, 1, HDP <= 48 ? 3 : 2>;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int KROW = padded_row(HDP);          // K/V row stride (elements)
  static constexpr int SMEM = Gemm::SMEM + 2 * SKP * KROW * 2;
};

struct Out : BlockGemmS8<128, 160, 128, 4, 2, 4> {      // tiles of out
  static constexpr int MIN_BLOCKS = 1;                   // resident blocks an SM (launch bounds)
};
struct OutThin : BlockGemmS8<64, 160, 128, 4, 2, 3> {   // ... where Out's grid is thin
  static constexpr int MIN_BLOCKS = 2;
};

// The scratch carved out of the caller's workspace, byte offsets (256-aligned)
struct Workspace {
  size_t xq, xs, o, pmax, oq, os, total;
  Workspace(int M, int C, int H) {
    size_t off = 0;
    auto take = [&off](size_t bytes) {
      const size_t at = off;
      off += (bytes + 255) / 256 * 256;
      return at;
    };
    xq = take((size_t)M * C);                  // x_q [M, C] int8
    xs = take((size_t)M * 4);                  // xs [M] f32
    o = take((size_t)M * C * 4);               // o [M, C] f32, the head concat
    pmax = take((size_t)M * H * 4);            // max|o_h| a row a head [M, H] f32
    oq = take((size_t)M * C);                  // o_q [M, C] int8
    os = take((size_t)M * 4);                  // os [M] f32
    total = off;
  }
};

// grid rows_grid<L>(M), M = B*N, L lanes a row: xs[r], x_q[r]
template <int L>
__global__ void __launch_bounds__(RWARPS * 32)
cross_int8_quant_x_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                          float* __restrict__ xs, int M, int C) {
  quant_x_rows<L>(x, xq, xs, M, C);
}

// grid (H, ceil(N / BM), B): o[b, n0:n0+BM, h*hd:(h+1)*hd] in fp32 and
// pmax[b, n0:n0+BM, h] = max|o_h| of each row
template <int HDP>
__global__ void __launch_bounds__(QAttn<HDP>::Gemm::NTHREADS, QAttn<HDP>::MIN_BLOCKS)
cross_int8_q_attn_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                         const int8_t* __restrict__ wq, const float* __restrict__ sq,
                         const bf16* __restrict__ k, const bf16* __restrict__ v,
                         float* __restrict__ o, float* __restrict__ pmax, int N, int C,
                         int H, int S, float f) {
  using Cfg = QAttn<HDP>;
  using G = typename Cfg::Gemm;
  constexpr int MT = Cfg::MT, NT = G::NT, KS = HDP / 16, KROW = Cfg::KROW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + G::SMEM);
  bf16* Vs = Ks + SKP * KROW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, n0 = blockIdx.y * G::BM, b = blockIdx.z;
  const int hd = C / H;
  const long rb = (long)b * N;           // the batch row's first row of x_q, o, pmax

  // K_h and V_h first (inputs of the call, not the x pass's), in their own
  // commit group: the main loop's first wait lands them, its barriers
  // publish them
  stage_head_kv<SKP, HDP, KROW, G::NTHREADS>(Ks, Vs, k + (long)b * S * C + h * hd,
                                             v + (long)b * S * C + h * hd, S, C, hd, tid);
  cp_async_commit();

  const int c = G::col_of(tid);
  typename G::ARows a;
#pragma unroll
  for (int i = 0; i < G::A_LOADS; ++i) {
    const int r = n0 + G::row_of(tid, i);
    a.ok[i] = r < N;
    a.src[i] = xq + (rb + (a.ok[i] ? r : 0)) * C + c;
  }
  typename G::BRows bw;                  // Wq_q rows h*hd + r; rows r >= hd read as zeros
#pragma unroll
  for (int i = 0; i < G::B_LOADS; ++i) {
    const int r = G::row_of(tid, i);
    bw.ok[i] = r < hd;
    bw.src[i] = wq + (long)(h * hd + (bw.ok[i] ? r : 0)) * C + c;
  }
  wait_for_predecessor();                // x_q, xs
  int acc[MT][NT][4];
  G::mainloop(acc, ring, a, bw, C, tid);

  // q_h dequantized and rounded to bf16: the C fragments of n8 tiles 2kk,
  // 2kk+1 are the A fragment of k step kk
  const int t = lane % 4, g = lane / 4, row0 = warp * MT * 16;
  float rs[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + row0 + mt * 16 + g + 8 * r;
      rs[mt][r] = n < N ? xs[rb + n] : 0.f;
    }
  uint32_t qf[MT][KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    float cs[2][2];                      // column scales of n8 tiles 2kk, 2kk+1 (0 past hd)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = (2 * kk + j) * 8 + 2 * t + e;
        cs[j][e] = col < hd ? sq[h * hd + col] : 0.f;
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          qf[mt][kk][2 * j + r] =
              pack_bf16(dequant(acc[mt][2 * kk + j][2 * r], rs[mt][r], cs[j][0]),
                        dequant(acc[mt][2 * kk + j][2 * r + 1], rs[mt][r], cs[j][1]));
  }

  // exact softmax over the SKP keys of each row: p = exp(s*f - max) / sum
  float s[MT][NKT][4];
  qk_product<MT, KS, NKT, KROW>(s, qf, Ks, lane);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] *= f;
  mask_keys_past<MT, NKT>(s, 0, S, t);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < NKT; ++j) m = fmaxf(m, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
      m = quad_max(m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[mt][j][e] = expf(s[mt][j][e] - m);
          sum += s[mt][j][e];
        }
      const float inv = 1.f / quad_sum(sum);
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        s[mt][j][2 * r] *= inv;
        s[mt][j][2 * r + 1] *= inv;
      }
    }

  // O_h = P . V_h, P rounded to bf16 as it enters the product
  float oacc[MT][HDP / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dn = 0; dn < HDP / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][dn][e] = 0.f;
  pv_product<MT, NKT, HDP / 8, KROW>(oacc, s, Vs, lane);

  // O_h in fp32 -> o's columns [h*hd, h*hd + hd) of the rows before N, and
  // each row's max|O_h| -> pmax (the padded columns are zeros)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + row0 + mt * 16 + g + 8 * r;
      float mx = 0.f;
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn)
        mx = fmaxf(mx, fmaxf(fabsf(oacc[mt][dn][2 * r]), fabsf(oacc[mt][dn][2 * r + 1])));
      mx = quad_max(mx);                 // the quad's four lanes share the row
      if (n >= N) continue;
      float* orow = o + (rb + n) * C + h * hd;
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn) {
        const int col = dn * 8 + 2 * t;
        const float v0 = oacc[mt][dn][2 * r], v1 = oacc[mt][dn][2 * r + 1];
        if (hd % 2 == 0) {
          if (col < hd) *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          if (col < hd) orow[col] = v0;
          if (col + 1 < hd) orow[col + 1] = v1;
        }
      }
      if (t == 0) pmax[(rb + n) * H + h] = mx;
    }
}

// grid rows_grid<L>(M), L lanes a row: os[r] from the row's H partial
// maxima, o_q[r] = quant(o[r], os[r])
template <int L>
__global__ void __launch_bounds__(RWARPS * 32)
cross_int8_quant_o_kernel(const float* __restrict__ o, const float* __restrict__ pmax,
                          int8_t* __restrict__ oq, float* __restrict__ os, int M, int C,
                          int H) {
  wait_for_predecessor();                // o, pmax
  quant_partial_rows<L>(o, pmax, H, oq, os, M, C);
}

// grid (ceil(C / BN), ceil(M / BM)): out[m0:m0+BM, n0:n0+BN] for n0 = BN * blockIdx.x
template <class G>
__global__ void __launch_bounds__(G::NTHREADS, G::MIN_BLOCKS)
cross_int8_out_kernel(const int8_t* __restrict__ oq, const float* __restrict__ os,
                      const int8_t* __restrict__ wo, const float* __restrict__ so,
                      const float* __restrict__ bo, bf16* __restrict__ out, int M, int C) {
  out_tile<G>(oq, os, wo, so, bo, out, M, C, C);
}

// What the launches need to know of the card, found once: the out kernels'
// shared-memory limits set (they take more than 48 KB), and its SMs.
struct Card {
  cudaError_t err;
  int sms;
};

const Card& card() {
  static const Card c = [] {
    Card k{cudaSuccess, 0};
    int device = 0;
    k.err = cudaFuncSetAttribute(cross_int8_out_kernel<Out>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Out::SMEM);
    if (k.err == cudaSuccess)
      k.err = cudaFuncSetAttribute(cross_int8_out_kernel<OutThin>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, OutThin::SMEM);
    if (k.err == cudaSuccess) k.err = cudaGetDevice(&device);
    if (k.err == cudaSuccess)
      k.err = cudaDeviceGetAttribute(&k.sms, cudaDevAttrMultiProcessorCount, device);
    return k;
  }();
  return c;
}

// The q-attention kernel's operands; with `info` set, describe it instead
// of launching it.
struct QCall {
  const int8_t* xq;
  const float* xs;
  const int8_t* wq;
  const float* sq;
  const bf16 *k, *v;
  float *o, *pmax;
  int B, N, C, H, S;
  float f;
  cudaStream_t stream;
  int* info;
};

template <int HDP>
cudaError_t q_call(const QCall& a) {
  using Cfg = QAttn<HDP>;
  static const cudaError_t err = cudaFuncSetAttribute(   // above 48 KB; set once
      cross_int8_q_attn_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, (a.N + Cfg::Gemm::BM - 1) / Cfg::Gemm::BM, a.B);
  if (a.info)
    return describe_one(cross_int8_q_attn_kernel<HDP>, Cfg::Gemm::NTHREADS, Cfg::SMEM,
                        Cfg::Gemm::BM, HDP, grid, a.info);
  return launch_after(cross_int8_q_attn_kernel<HDP>, grid, Cfg::Gemm::NTHREADS, Cfg::SMEM,
                      a.stream, a.xq, a.xs, a.wq, a.sq, a.k, a.v, a.o, a.pmax, a.N, a.C, a.H,
                      a.S, a.f);
}

// q_call at hdp = round_up(hd, 16), hd <= 160
cudaError_t q_dispatch(const QCall& a) {
  switch ((a.C / a.H + 15) / 16 * 16) {
    case 16: return q_call<16>(a);
    case 32: return q_call<32>(a);
    case 48: return q_call<48>(a);
    case 64: return q_call<64>(a);
    case 80: return q_call<80>(a);
    case 96: return q_call<96>(a);
    case 112: return q_call<112>(a);
    case 128: return q_call<128>(a);
    case 144: return q_call<144>(a);
    case 160: return q_call<160>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The row passes' lanes a row at width C
int row_lanes(int C) {
  int L = MIN_ROW_LANES;
  while (L < 32 && C > 8 * XU * L) L *= 2;
  return L;
}

// The x pass (the call's first kernel) and the o pass at L lanes a row; with
// `info` set, describe the kernel instead of launching it.
template <int L>
cudaError_t quant_x_at(const bf16* x, int8_t* xq, float* xs, int M, int C, cudaStream_t s,
                       int* info) {
  if (info)
    return describe_one(cross_int8_quant_x_kernel<L>, RWARPS * 32, 0, RWARPS * 32 / L, C,
                        rows_grid<L>(M), info);
  cross_int8_quant_x_kernel<L><<<rows_grid<L>(M), RWARPS * 32, 0, s>>>(x, xq, xs, M, C);
  return cudaGetLastError();
}

template <int L>
cudaError_t quant_o_at(const float* o, const float* pmax, int8_t* oq, float* os, int M, int C,
                       int H, cudaStream_t s, int* info) {
  if (info)
    return describe_one(cross_int8_quant_o_kernel<L>, RWARPS * 32, 0, RWARPS * 32 / L, C,
                        rows_grid<L>(M), info);
  return launch_after(cross_int8_quant_o_kernel<L>, rows_grid<L>(M), RWARPS * 32, 0, s, o, pmax,
                      oq, os, M, C, H);
}

// ... at L = row_lanes(C)
cudaError_t quant_x(const bf16* x, int8_t* xq, float* xs, int M, int C, cudaStream_t s,
                    int* info) {
  switch (row_lanes(C)) {
    case 8: return quant_x_at<8>(x, xq, xs, M, C, s, info);
    case 16: return quant_x_at<16>(x, xq, xs, M, C, s, info);
    default: return quant_x_at<32>(x, xq, xs, M, C, s, info);
  }
}

cudaError_t quant_o(const float* o, const float* pmax, int8_t* oq, float* os, int M, int C,
                    int H, cudaStream_t s, int* info) {
  switch (row_lanes(C)) {
    case 8: return quant_o_at<8>(o, pmax, oq, os, M, C, H, s, info);
    case 16: return quant_o_at<16>(o, pmax, oq, os, M, C, H, s, info);
    default: return quant_o_at<32>(o, pmax, oq, os, M, C, H, s, info);
  }
}

bool shapes_ok(int B, int N, int C, int H, int S) {
  return B > 0 && N > 0 && C > 0 && C % 16 == 0 && H > 0 && C % H == 0 && C / H <= 160 &&
         S > 0 && S <= SKP;
}

template <class G>
dim3 out_grid(int M, int C) {
  return dim3((C + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
}

// The out kernel takes 64-row tiles, two blocks an SM, where its 128-row
// grid would leave more than half the SMs idle: at C=640 N=1024 B=2, the
// serving stack's cond-only steps at the 32x32 level.
bool out_thin(int M, int C) {
  const dim3 grid = out_grid<Out>(M, C);
  return 2 * (int)(grid.x * grid.y) <= card().sms;
}

template <class G>
cudaError_t launch_out(const int8_t* oq, const float* os, const void* wo, const void* so,
                       const void* bo, void* out, int M, int C, cudaStream_t s) {
  return launch_after(cross_int8_out_kernel<G>, out_grid<G>(M, C), G::NTHREADS, G::SMEM, s,
                      oq, os, static_cast<const int8_t*>(wo), static_cast<const float*>(so),
                      static_cast<const float*>(bo), static_cast<bf16*>(out), M, C);
}

}  // namespace

// The bytes of the workspace fused_cross_attention_int8_fwd takes at these
// shapes, into *bytes.
extern "C" int fused_cross_int8_workspace(int B, int N, int C, int H, long long* bytes) {
  if (!shapes_ok(B, N, C, H, 1)) return (int)cudaErrorInvalidValue;
  *bytes = (long long)Workspace(B * N, C, H).total;
  return 0;
}

// Returns a cudaError_t code: 0 when all four launches were accepted. The
// kernels run on `stream` back to back; `workspace` holds
// fused_cross_int8_workspace bytes, 256-byte aligned.
extern "C" int fused_cross_attention_int8_fwd(const void* x, const void* wq, const void* sq,
                                              const void* k, const void* v, const void* wo,
                                              const void* so, const void* bo, void* out,
                                              void* workspace, int B, int N, int C, int H,
                                              int S, float scale, void* stream) {
  if (!shapes_ok(B, N, C, H, S)) return (int)cudaErrorInvalidValue;
  if (card().err != cudaSuccess) return (int)card().err;
  const int M = B * N;
  const Workspace W(M, C, H);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  int8_t* xq = reinterpret_cast<int8_t*>(ws + W.xq);
  float* xs = reinterpret_cast<float*>(ws + W.xs);
  float* o = reinterpret_cast<float*>(ws + W.o);
  float* pmax = reinterpret_cast<float*>(ws + W.pmax);
  int8_t* oq = reinterpret_cast<int8_t*>(ws + W.oq);
  float* os = reinterpret_cast<float*>(ws + W.os);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = quant_x(static_cast<const bf16*>(x), xq, xs, M, C, s, nullptr);
  if (err != cudaSuccess) return (int)err;
  const QCall a{xq, xs, static_cast<const int8_t*>(wq), static_cast<const float*>(sq),
                static_cast<const bf16*>(k), static_cast<const bf16*>(v), o, pmax, B, N, C, H,
                S, scale, s, nullptr};
  err = q_dispatch(a);
  if (err != cudaSuccess) return (int)err;
  err = quant_o(o, pmax, oq, os, M, C, H, s, nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)(out_thin(M, C) ? launch_out<OutThin>(oq, os, wo, so, bo, out, M, C, s)
                              : launch_out<Out>(oq, os, wo, so, bo, out, M, C, s));
}

// Fills info[7k..7k+6] for kernel k of the call in launch order (quant_x,
// q_attn, quant_o, out) at these shapes (77 keys): registers a thread, shared
// memory a block (bytes), rows and columns a tile (the q-attention tile's
// columns are one head's, padded; a row pass's are a row's), resident blocks
// an SM, blocks in the grid, local memory a thread (bytes).
extern "C" int fused_cross_int8_describe(int B, int N, int C, int H, int* info) {
  if (!shapes_ok(B, N, C, H, 77)) return (int)cudaErrorInvalidValue;
  if (card().err != cudaSuccess) return (int)card().err;
  const int M = B * N;
  cudaError_t err = quant_x(nullptr, nullptr, nullptr, M, C, nullptr, info);
  if (err != cudaSuccess) return (int)err;
  const QCall a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                B, N, C, H, 77, 0.f, nullptr, info + 7};
  err = q_dispatch(a);
  if (err != cudaSuccess) return (int)err;
  err = quant_o(nullptr, nullptr, nullptr, nullptr, M, C, H, nullptr, info + 14);
  if (err != cudaSuccess) return (int)err;
  if (out_thin(M, C))
    return (int)describe_one(cross_int8_out_kernel<OutThin>, OutThin::NTHREADS, OutThin::SMEM,
                             OutThin::BM, OutThin::BN, out_grid<OutThin>(M, C), info + 21);
  return (int)describe_one(cross_int8_out_kernel<Out>, Out::NTHREADS, Out::SMEM, Out::BM,
                           Out::BN, out_grid<Out>(M, C), info + 21);
}
