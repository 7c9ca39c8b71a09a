// Fused self-attention for Hopper (sm_90a), forward only, as two kernels in
// one C call:
//   q = bf16(x . Wq^T);  per head h: o_h = softmax(q_h . k_h^T * scale + key_bias) . v_h
//   o = bf16(concat_h(o_h));  out = bf16(o . Wo^T + bo)
// over all N keys of a packed K|V tensor.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fused_self_kernel
// (launched from fused_self_attention). Layouts: x [B, N, C] bf16; Wq, Wo
// [C, C] bf16 in PyTorch's [out, in] layout; kv [B, N, 2C] bf16, K in columns
// [0, C) and V in [C, 2C), head h in columns h*hd of each half (the wrapper's
// one x.[Wk|Wv] product, left to torch.matmul as the JAX package leaves it
// to XLA); bo [C] f32; key_bias [B, N] f32 or NULL; o [B, N, C] bf16 scratch
// (the wrapper allocates it); out [B, N, C] bf16. hd = C / H is a multiple
// of 8, at most 480.
//
// What bounds it: the attention, 4*N*N*C operations per batch row and one
// exponential per score and head, plus the two C x C projections (4*N*C*C);
// bytes are x, kv and out once. At C=320 N=4096 that is ~1,500 operations a
// byte: the tensor cores and, at hd=40, the exponentials bind (as in the
// flash forward, csrc/flash_attention.cu), not the memory.
//
// Design. The TPU kernel keeps a batch row's whole [N, 2C] K|V in VMEM and
// walks the heads of a row tile in turn, normalizing p before p.v. An SM has
// 227 KB, so the call is split where both packages round the head concat o
// to bf16, as the fused cross-attention (csrc/fused_cross_attention.cu) is:
//   * self_q_attn_kernel, grid (head, row tile, batch row): the cross
//     kernel's q-projection prologue feeding the flash forward's key loop.
//     A tile of BM rows x hdp = round_up(hd, 16) columns of q_h = x . Wq_h^T
//     (K = C) on block_gemm.cuh's main loop, 4 warps of 16*MT rows each; the
//     rows hd..hdp-1 of its Wq tile are zero-filled, so q's pad columns are
//     exact zeros. The q sums, rounded to bf16 in pairs, become the A
//     fragments of S = q_h . k_h^T in registers, where they stay for the
//     whole key loop. The drained ring becomes a ring of 64-key K/V tiles and
//     their key bias, read by cp.async from kv with a row stride of 2C
//     (stage_kv of flash_sm90.cuh); the pad columns of the K rows are zeroed
//     once. Per tile, the flash forward's steps on registers: S, the key bias
//     (the max then taken in log2 units) or the scale folded into the
//     exponent, keys past N at -inf, the online softmax (running max and
//     per-thread partial sums, ex2.approx), P rounded to bf16 straight from
//     the score registers into O += P . V (V by ldmatrix.trans, over hd in
//     n8 steps). The online form rounds the unnormalized p and divides by the
//     row sum at the end: the TPU kernel's function up to rounding. O_h / l,
//     rounded to bf16, goes through the warp's own rows of a staging tile
//     beside the ring into o's columns [h*hd, (h+1)*hd), 16 bytes a lane.
//     128 rows a block (two m16 tiles a warp) at hdp <= 80, 64 above; three
//     K/V stages at hdp <= 64, two above (the flash forward's tiles). Above
//     hd = 160 (one head or two at the widest C; no UNet layer) q's and O's
//     registers would not fit: q is computed in passes of 80 columns into
//     the fragments of a q.k^T up to 480 deep, and O in chunks of 80 columns,
//     a chunk a block (grid (head * chunk, ...)), each block recomputing q
//     and the scores.
//   * self_out_kernel: out = o . Wo^T + bo on the same main loop with the
//     bias epilogue of block_gemm.cuh's bias_out_tile (the cross kernel's).
// The heads' blocks of one row tile are neighbours in launch order, so x is
// re-read from the 50 MB L2; a batch row's K|V (5.2 MB at C=320 N=4096) stays
// there while its row tiles run. Nothing is summed across blocks, so two
// calls give equal bits. Not built: wgmma and TMA, and a persistent grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace block_gemm;
using namespace flash_sm90;
using bf16 = __nv_bfloat16;

constexpr int MAX_DN = 20;               // head dims up to 160: one block a head and row tile
constexpr int WIDE_QC = 80;              // above, q in 80-column passes, O in 80-column chunks,
constexpr int MAX_HD = 6 * WIDE_QC;      // head dims up to 480

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The q-attention kernel's tile: q.k^T over HDP columns (hd padded to 16,
// or to 80 above hd = 160), q computed in passes of QC columns, O over a
// chunk of 8*DVN columns of the head; 4 warps of 16*MT rows each; its
// shared memory, byte offsets. Up to hd = 160 one pass and one chunk
// (QC = HDP, DVN = hd / 8); above, NCH passes and NCH chunks of 80, a chunk
// a block, each block recomputing q and the scores.
template <int HDP_, int DVN_, int QC_>
struct QAttn {
  static constexpr int HDP = HDP_, DVN = DVN_, QC = QC_;
  static constexpr int NCH = HDP / QC;                   // q's passes, O's chunks
  static constexpr int MT = HDP <= 80 ? 2 : 1;           // m16 row tiles a warp
  using Gemm = BlockGemm<64 * MT, QC, 64, 4, 1, HDP <= 48 ? 3 : 2>;
  static constexpr int MIN_BLOCKS = NCH == 1 ? 2 : 1;
  static constexpr int BK = 64;                          // keys a tile
  static constexpr int NSTAGE = HDP <= 64 ? 3 : 2;       // K/V stages in the ring
  static constexpr int KROW = padded_row(HDP);           // K row stride (elements)
  static constexpr int VROW = padded_row((8 * DVN + 15) / 16 * 16);   // V and staging rows
  static constexpr int STAGE = BK * (KROW + VROW);       // elements a K/V stage
  static constexpr int BIAS = NSTAGE * STAGE * 2;                // [NSTAGE][BK] key bias
  static constexpr int STG = BIAS + NSTAGE * BK * 4;             // [BM][VROW] O staging
  static constexpr int SMEM = cmax(Gemm::SMEM, STG + Gemm::BM * VROW * 2);
};

using Out = BlockGemm<128, 160, 64, 4, 2, 4>;            // tiles of out
constexpr int OUT_MIN_BLOCKS = 1;

// grid (H * NCH, ceil(N / BM), B): o[b, n0:n0+BM, h*hd + v0 : h*hd + v0 + 8*DVN]
template <int HDP, int DVN, int QC>
__global__ void __launch_bounds__(QAttn<HDP, DVN, QC>::Gemm::NTHREADS,
                                  QAttn<HDP, DVN, QC>::MIN_BLOCKS)
self_q_attn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                   const bf16* __restrict__ kv, const float* __restrict__ bias,
                   bf16* __restrict__ o, int N, int C, int H, float scale_log2) {
  using Cfg = QAttn<HDP, DVN, QC>;
  using G = typename Cfg::Gemm;
  constexpr int MT = Cfg::MT, NCH = Cfg::NCH, KS = HDP / 16, BK = Cfg::BK, NT = BK / 8;
  constexpr int NSTAGE = Cfg::NSTAGE, KROW = Cfg::KROW, VROW = Cfg::VROW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, t = lane % 4;
  const int hc = blockIdx.x, n0 = blockIdx.y * G::BM, b = blockIdx.z;
  const int h = hc / NCH, v0 = hc % NCH * 8 * DVN;      // the head, its chunk's first column
  const int hd = NCH == 1 ? 8 * DVN : C / H;
  const int ku = NCH == 1 ? DVN : hd / 8;                // 16-byte units of a K row

  // q_h = x . Wq_h^T in passes of QC columns; Wq rows h*hd + r, rows r >= hd
  // read as zeros. The sums of a pass, rounded to bf16 in pairs, are A
  // fragments: the C fragments of n8 tiles 2kk, 2kk+1 are those of k step kk.
  const bf16* xb = x + (long)b * N * C;
  const int c = G::col_of(tid);
  typename G::ARows a;
#pragma unroll
  for (int i = 0; i < G::A_LOADS; ++i) {
    const int r = n0 + G::row_of(tid, i);
    a.ok[i] = r < N;
    a.src[i] = xb + (long)(a.ok[i] ? r : 0) * C + c;
  }
  uint32_t qf[MT][KS][4];
#pragma unroll
  for (int p = 0; p < NCH; ++p) {
    typename G::BRows bw;
#pragma unroll
    for (int i = 0; i < G::B_LOADS; ++i) {
      const int r = p * QC + G::row_of(tid, i);
      bw.ok[i] = r < hd;
      bw.src[i] = wq + (long)(h * hd + (bw.ok[i] ? r : 0)) * C + c;
    }
    float acc[MT][G::NT][4];
    G::mainloop(acc, smem, a, bw, C, tid);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        const int k = p * (QC / 16) + kk;
        qf[mt][k][0] = pack_bf16(acc[mt][2 * kk][0], acc[mt][2 * kk][1]);
        qf[mt][k][1] = pack_bf16(acc[mt][2 * kk][2], acc[mt][2 * kk][3]);
        qf[mt][k][2] = pack_bf16(acc[mt][2 * kk + 1][0], acc[mt][2 * kk + 1][1]);
        qf[mt][k][3] = pack_bf16(acc[mt][2 * kk + 1][2], acc[mt][2 * kk + 1][3]);
      }
  }

  // the drained ring -> [NSTAGE][K [BK][KROW], V [BK][VROW]] tiles, their key
  // bias, and O's staging tile; K/V of head h are columns h*hd of kv's two
  // halves, and this block's V columns v0 .. v0 + 8*DVN of the head
  bf16* KVs = smem;
  float* Bs = reinterpret_cast<float*>(smem_raw + Cfg::BIAS);
  bf16* Stg = reinterpret_cast<bf16*>(smem_raw + Cfg::STG);
  const long rs = 2L * C;
  const bf16* kb = kv + (long)b * N * rs + h * hd;
  const bf16* vb = kb + C + v0;
  const float* biasb = bias ? bias + (long)b * N : nullptr;
  const int ntiles = (N + BK - 1) / BK;
  const int pad = HDP / 8 - ku;          // the K rows' pad units [hd, HDP): zero, never staged
  for (int i = tid; i < NSTAGE * BK * pad; i += G::NTHREADS) {
    const int r = i / pad, u = ku + i % pad;
    *reinterpret_cast<uint4*>(KVs + r / BK * Cfg::STAGE + r % BK * KROW + u * 8) =
        make_uint4(0, 0, 0, 0);
  }
  auto load_kv = [&](int n) {          // key tile n -> stage n % NSTAGE; keys past N zero-filled
    bf16* Kst = KVs + (n % NSTAGE) * Cfg::STAGE;
    float* Bst = Bs + (n % NSTAGE) * BK;
    const int k0 = n * BK;
    if constexpr (NCH == 1) {
      stage_kv<DVN, BK, KROW, G::NTHREADS>(Kst, Kst + BK * KROW, Bst, kb, vb, biasb, k0, N, rs,
                                           tid);
    } else {                           // V's columns past hd zero-filled too
      bf16* Vst = Kst + BK * KROW;
      for (int i = tid; i < BK * ku; i += G::NTHREADS) {
        const int r = i / ku, cc = (i % ku) * 8;
        const bool ok = k0 + r < N;
        cp_async_16(smem_addr(Kst + r * KROW + cc), kb + (ok ? (k0 + r) * rs + cc : 0), ok);
      }
      for (int i = tid; i < BK * DVN; i += G::NTHREADS) {
        const int r = i / DVN, cc = (i % DVN) * 8;
        const bool ok = k0 + r < N && v0 + cc < hd;
        cp_async_16(smem_addr(Vst + r * VROW + cc), vb + (ok ? (k0 + r) * rs + cc : 0), ok);
      }
      if (biasb)
        for (int i = tid; i < BK; i += G::NTHREADS) {
          const bool ok = k0 + i < N;
          cp_async_4(smem_addr(Bst + i), biasb + (ok ? k0 + i : 0), ok);
        }
    }
  };
#pragma unroll
  for (int n = 0; n < NSTAGE - 1; ++n) {
    if (n < ntiles) load_kv(n);
    cp_async_commit();                   // one group per tile, empty or not
  }

  // With a key bias, scores are biased in the log2 domain before the max
  // (exponent factor 1); without one, the max is taken on the raw product
  // and the scale folds into the exponent.
  const float sc = biasb ? 1.f : scale_log2;
  float oacc[MT][DVN][4];
  float m[MT][2], l[MT][2];              // rows g and g+8 of each m16 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int dn = 0; dn < DVN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][dn][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) { m[mt][r] = -INFINITY; l[mt][r] = 0.f; }
  }

  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait<NSTAGE - 2>();         // tile n has landed (this thread's part)
    __syncthreads();                     // ... every thread's; tile n-1 consumed
    if (n + NSTAGE - 1 < ntiles) load_kv(n + NSTAGE - 1);    // into the stage tile n-1 left
    cp_async_commit();
    const bf16* Kst = KVs + (n % NSTAGE) * Cfg::STAGE;
    const int k0 = n * BK;
    float s[MT][NT][4];
    qk_product<MT, KS, NT, KROW>(s, qf, Kst, lane);
    if (biasb) add_key_bias<MT, NT>(s, Bs + (n % NSTAGE) * BK, scale_log2, t);
    if (k0 + BK > N) mask_keys_past<MT, NT>(s, k0, N, t);       // the ragged last tile
    online_softmax<MT, NT, DVN>(s, oacc, m, l, sc);
    pv_product<MT, NT, DVN, VROW>(oacc, s, Kst + BK * KROW, lane);
  }

  // O / l in bf16 -> the warp's own rows of the staging tile (no other warp
  // reads them, and no K/V stage lies there) -> o's columns h*hd + v0 on,
  // those before the head's end
  float inv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[mt][r] = 1.f / quad_sum(l[mt][r]);
  store_rows<MT, DVN, VROW, (NCH > 1)>(o + (long)b * N * C + h * hd + v0, Stg, oacc, inv,
                                       warp * 16 * MT, n0, N, C, lane, hd - v0);
}

// grid (ceil(C / BN), ceil(M / BM)), M = B*N: out[m0:m0+BM, n0:n0+BN]
__global__ void __launch_bounds__(Out::NTHREADS, OUT_MIN_BLOCKS)
self_out_kernel(const bf16* __restrict__ o, const bf16* __restrict__ wo,
                const float* __restrict__ bo, bf16* __restrict__ out, int M, int C) {
  bias_out_tile<Out>(o, wo, bo, out, M, C);
}

// The q-attention kernel's operands; with `info` set, describe it instead
// of launching it.
struct QCall {
  const bf16 *x, *wq, *kv;
  const float* bias;
  bf16* o;
  int B, N, C, H;
  float scale_log2;
  cudaStream_t stream;
  int* info;
};

template <int HDP, int DVN, int QC>
cudaError_t q_call(const QCall& a) {
  using Cfg = QAttn<HDP, DVN, QC>;
  static const cudaError_t err = cudaFuncSetAttribute(   // above 48 KB; set once
      self_q_attn_kernel<HDP, DVN, QC>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H * Cfg::NCH, (a.N + Cfg::Gemm::BM - 1) / Cfg::Gemm::BM, a.B);
  if (a.info)
    return describe_kernel<typename Cfg::Gemm>(self_q_attn_kernel<HDP, DVN, QC>, Cfg::SMEM, grid,
                                               a.info);
  self_q_attn_kernel<HDP, DVN, QC><<<grid, Cfg::Gemm::NTHREADS, Cfg::SMEM, a.stream>>>(
      a.x, a.wq, a.kv, a.bias, a.o, a.N, a.C, a.H, a.scale_log2);
  return cudaGetLastError();
}

// q_call at hd = C / H: one pass and one chunk at hd = 8*DN <= 160, else
// passes and chunks of 80 columns
cudaError_t q_dispatch(const QCall& a) {
  const int hd = a.C / a.H;
  if (hd > 8 * MAX_DN) {
    switch ((hd + WIDE_QC - 1) / WIDE_QC) {
      case 3: return q_call<3 * WIDE_QC, WIDE_QC / 8, WIDE_QC>(a);
      case 4: return q_call<4 * WIDE_QC, WIDE_QC / 8, WIDE_QC>(a);
      case 5: return q_call<5 * WIDE_QC, WIDE_QC / 8, WIDE_QC>(a);
      case 6: return q_call<6 * WIDE_QC, WIDE_QC / 8, WIDE_QC>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (hd / 8) {
#define SELF_Q_CASE(DN) \
    case DN: return q_call<(8 * DN + 15) / 16 * 16, DN, (8 * DN + 15) / 16 * 16>(a);
    SELF_Q_CASE(1) SELF_Q_CASE(2) SELF_Q_CASE(3) SELF_Q_CASE(4) SELF_Q_CASE(5)
    SELF_Q_CASE(6) SELF_Q_CASE(7) SELF_Q_CASE(8) SELF_Q_CASE(9) SELF_Q_CASE(10)
    SELF_Q_CASE(11) SELF_Q_CASE(12) SELF_Q_CASE(13) SELF_Q_CASE(14) SELF_Q_CASE(15)
    SELF_Q_CASE(16) SELF_Q_CASE(17) SELF_Q_CASE(18) SELF_Q_CASE(19) SELF_Q_CASE(20)
#undef SELF_Q_CASE
    default: return cudaErrorInvalidValue;
  }
}

// More than 48 KB of dynamic shared memory; set once.
cudaError_t out_smem_limit() {
  static const cudaError_t err = cudaFuncSetAttribute(
      self_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Out::SMEM);
  return err;
}

dim3 out_grid(int M, int C) {
  return dim3((C + Out::BN - 1) / Out::BN, (M + Out::BM - 1) / Out::BM);
}

bool shapes_ok(int B, int N, int C, int H) {
  return B > 0 && N > 0 && C > 0 && C % 16 == 0 && H > 0 && C % H == 0 && (C / H) % 8 == 0 &&
         C / H <= MAX_HD;
}

}  // namespace

// Returns a cudaError_t code: 0 when both launches were accepted. The two
// kernels run on `stream` back to back, o between them.
extern "C" int fused_self_attention_fwd(const void* x, const void* wq, const void* kv,
                                        const void* wo, const void* bo, const void* bias,
                                        void* o, void* out, int B, int N, int C, int H,
                                        float scale, void* stream) {
  if (!shapes_ok(B, N, C, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QCall a{static_cast<const bf16*>(x),    static_cast<const bf16*>(wq),
                static_cast<const bf16*>(kv),   static_cast<const float*>(bias),
                static_cast<bf16*>(o),          B, N, C, H, scale * kLog2e, st, nullptr};
  cudaError_t err = q_dispatch(a);
  if (err != cudaSuccess) return (int)err;
  err = out_smem_limit();
  if (err != cudaSuccess) return (int)err;
  self_out_kernel<<<out_grid(B * N, C), Out::NTHREADS, Out::SMEM, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(wo), static_cast<const float*>(bo),
      static_cast<bf16*>(out), B * N, C);
  return (int)cudaGetLastError();
}

// Fills info[0..6] for self_q_attn_kernel and info[7..13] for
// self_out_kernel at these shapes: registers a thread, shared memory a block
// (bytes), rows and columns a tile (the q kernel's columns are one head's,
// padded), resident blocks an SM, blocks in the grid, local memory a thread
// (bytes).
extern "C" int fused_self_describe(int B, int N, int C, int H, int* info) {
  if (!shapes_ok(B, N, C, H)) return (int)cudaErrorInvalidValue;
  const QCall a{nullptr, nullptr, nullptr, nullptr, nullptr, B, N, C, H, 0.f, nullptr, info};
  cudaError_t err = q_dispatch(a);
  if (err != cudaSuccess) return (int)err;
  err = out_smem_limit();
  if (err != cudaSuccess) return (int)err;
  return (int)describe_kernel<Out>(self_out_kernel, Out::SMEM, out_grid(B * N, C), info + 7);
}
