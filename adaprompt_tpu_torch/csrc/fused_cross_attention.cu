// Fused cross-attention for Hopper (sm_90a), forward only, as two kernels in
// one C call:
//   q = bf16(x . Wq^T);  per head h: p_h = bf16(softmax(q_h . k_h^T * scale));
//   o = bf16(concat_h(p_h . v_h));  out = bf16(o . Wo^T + bo)
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fused_cross_kernel
// (launched from fused_cross_attention). Layouts: x [B, N, C] bf16; Wq, Wo
// [C, C] bf16 in PyTorch's [out, in] layout; k/v [B, S, H, hd] bf16 exactly
// as unet.precompute_cross_kv returns them (read with strides, no
// transpose); bo [C] f32; out [B, N, C] bf16. The rounding points are the
// TPU kernel's: q, the normalized probabilities (divided by their row sum
// before they are rounded) and the concatenated o are rounded to bf16; every
// sum is fp32.
//
// What bounds it: the two C x C projections, 4*N*C*C operations per batch
// row, and the attention over S = 77 keys, 4*N*S*C; bytes are x and out once
// (4*N*C per batch row) besides the weights and the tiny K/V. At C=320
// N=4096 and C=640 N=1024 that is ~390 and ~620 operations a byte, above the
// card's ridge of ~295, so the tensor cores bound it.
//
// Design. The TPU kernel keeps a row tile's q and o in VMEM and walks the
// heads in turn. On this card that form holds a [rows, C] tile of q and of o
// in shared memory, caps the row tile at 16-32 rows, and makes every block
// re-read both weights through L2. So the call is split where both packages
// already round o to bf16, into two kernels on the block-GEMM main loop of
// block_gemm.cuh (a cp.async ring 64 deep in K, ldmatrix, mma.sync.m16n8k16):
//   * cross_q_attn_kernel, grid (head, row tile, batch row): a tile of
//     BM rows x hdp = round_up(hd, 16) columns of q_h = x . Wq_h^T (K = C),
//     4 warps of 16*MT rows each. The rows hd..hdp-1 of its Wq tile are
//     zero-filled, never head h+1's, so q's padded columns are exact zeros.
//     K_h and V_h of the block's batch row (77 keys, padded to 80 with
//     zeros) go to their own shared memory by cp.async before the main loop,
//     beside the ring. The epilogue keeps each warp's rows in registers: the
//     q sums, rounded to bf16 in pairs, are the A fragments of S = q_h . K_h^T
//     over all 80 keys (one key tile, so the softmax is exact, not online:
//     scores times scale*log2(e), the padded keys -inf, quad reductions for
//     the row max and sum, exp2f); P is normalized, rounded to bf16 and fed
//     from the registers to O_h = P . V_h (V by ldmatrix.trans). O_h, rounded
//     to bf16, is staged in the drained ring in the warp's own rows and
//     written to the o scratch [B, N, C] (which the wrapper allocates) at
//     columns [h*hd, (h+1)*hd) only: 16 bytes a lane where hd % 8 == 0,
//     2 bytes otherwise (K/V likewise go through plain loads then). No block
//     barrier after the main loop.
//   * cross_out_kernel: out = o . Wo^T + bo on the same main loop, with the
//     bias epilogue of the GEGLU's out kernel (block_gemm.cuh's
//     bias_out_tile, which the fused self-attention's out kernel shares).
// The heads' blocks of one row tile are neighbours in launch order, as are
// the column tiles of the out kernel's row tile, so x and o are re-read from
// the 50 MB L2 (o is 10.5 MB at C=320 N=4096 B=4). Limits: S <= 80 keys and
// hd <= 160 (the wrapper refuses others by name; the UNet passes 77 keys and
// head dims 40 and 80). Not built: wgmma and TMA, and fusing the
// out-projection back in (a block would have to own all C columns of its
// rows: a split-K over heads with atomics, or a cluster reduction).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace block_gemm;
using namespace flash_sm90;
using bf16 = __nv_bfloat16;

constexpr int SKP = 80;                  // keys a block holds: S padded to 10 n8 tiles
constexpr int NKT = SKP / 8;

// The q-attention kernel's tile at padded head dim HDP: 4 warps of 16*MT
// rows, each over all HDP columns.
template <int HDP>
struct QAttn {
  static constexpr int MT = HDP <= 80 ? 2 : 1;
  using Gemm = BlockGemm<64 * MT, HDP, 64, 4, 1, HDP <= 48 ? 3 : 2>;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int KROW = padded_row(HDP);          // K/V row stride (elements)
  static constexpr int SMEM = Gemm::SMEM + 2 * SKP * KROW * 2;
};

using Out = BlockGemm<128, 160, 64, 4, 2, 4>;            // tiles of out
constexpr int OUT_MIN_BLOCKS = 1;

// grid (H, ceil(N / BM), B): o[b, n0:n0+BM, h*hd:(h+1)*hd]
template <int HDP>
__global__ void __launch_bounds__(QAttn<HDP>::Gemm::NTHREADS, QAttn<HDP>::MIN_BLOCKS)
cross_q_attn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                    const bf16* __restrict__ k, const bf16* __restrict__ v,
                    bf16* __restrict__ o, int N, int C, int H, int S, float scale_log2) {
  using Cfg = QAttn<HDP>;
  using G = typename Cfg::Gemm;
  constexpr int MT = Cfg::MT, NT = G::NT, KS = HDP / 16, KROW = Cfg::KROW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = smem + G::SMEM / 2;
  bf16* Vs = Ks + SKP * KROW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, n0 = blockIdx.y * G::BM, b = blockIdx.z;
  const int hd = C / H;

  // K_h and V_h first, in their own commit group: the main loop's first wait
  // lands them, its barriers publish them
  stage_head_kv<SKP, HDP, KROW, G::NTHREADS>(Ks, Vs, k + (long)b * S * C + h * hd,
                                             v + (long)b * S * C + h * hd, S, C, hd, tid);
  cp_async_commit();

  const bf16* xb = x + (long)b * N * C;
  const int c = G::col_of(tid);
  typename G::ARows a;
#pragma unroll
  for (int i = 0; i < G::A_LOADS; ++i) {
    const int r = n0 + G::row_of(tid, i);
    a.ok[i] = r < N;
    a.src[i] = xb + (long)(a.ok[i] ? r : 0) * C + c;
  }
  typename G::BRows bw;                  // Wq rows h*hd + r; rows r >= hd read as zeros
#pragma unroll
  for (int i = 0; i < G::B_LOADS; ++i) {
    const int r = G::row_of(tid, i);
    bw.ok[i] = r < hd;
    bw.src[i] = wq + (long)(h * hd + (bw.ok[i] ? r : 0)) * C + c;
  }
  float acc[MT][NT][4];
  G::mainloop(acc, smem, a, bw, C, tid);

  // q_h rounded to bf16: the C fragments of n8 tiles 2kk, 2kk+1 are the A
  // fragment of k step kk
  uint32_t qf[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[mt][kk][0] = pack_bf16(acc[mt][2 * kk][0], acc[mt][2 * kk][1]);
      qf[mt][kk][1] = pack_bf16(acc[mt][2 * kk][2], acc[mt][2 * kk][3]);
      qf[mt][kk][2] = pack_bf16(acc[mt][2 * kk + 1][0], acc[mt][2 * kk + 1][1]);
      qf[mt][kk][3] = pack_bf16(acc[mt][2 * kk + 1][2], acc[mt][2 * kk + 1][3]);
    }

  // exact softmax over the SKP keys of each row: p = exp2(s*f - max) / sum
  float s[MT][NKT][4];
  qk_product<MT, KS, NKT, KROW>(s, qf, Ks, lane);
  const int t = lane % 4, g = lane / 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] *= scale_log2;
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
          s[mt][j][e] = exp2f(s[mt][j][e] - m);
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

  // O_h in bf16 -> the warp's own rows of the drained ring -> o's columns
  // [h*hd, h*hd + hd) of the rows before N
  using T = Staging<G, HDP>;
  const int row0 = warp * MT * 16;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int dn = 0; dn < HDP / 8; ++dn)
        T::put(smem, row0 + mt * 16 + g + 8 * r, dn * 8 + 2 * t, oacc[mt][dn][2 * r],
               oacc[mt][dn][2 * r + 1]);
  __syncwarp();
  bf16* ob = o + ((long)b * N + n0) * C + h * hd;
  if (hd % 8 == 0) {
    const int units = hd / 8;
    for (int i = lane; i < 16 * MT * units; i += 32) {
      const int row = row0 + i / units, cc = (i % units) * 8;
      if (n0 + row < N)
        *reinterpret_cast<uint4*>(ob + (long)row * C + cc) =
            *reinterpret_cast<const uint4*>(smem + row * T::ROW + cc);
    }
  } else {
    for (int i = lane; i < 16 * MT * hd; i += 32) {
      const int row = row0 + i / hd, d = i % hd;
      if (n0 + row < N) ob[(long)row * C + d] = smem[row * T::ROW + d];
    }
  }
}

// grid (ceil(C / BN), ceil(M / BM)), M = B*N: out[m0:m0+BM, n0:n0+BN]
__global__ void __launch_bounds__(Out::NTHREADS, OUT_MIN_BLOCKS)
cross_out_kernel(const bf16* __restrict__ o, const bf16* __restrict__ wo,
                 const float* __restrict__ bo, bf16* __restrict__ out, int M, int C) {
  bias_out_tile<Out>(o, wo, bo, out, M, C);
}

// The q-attention kernel's operands; with `info` set, describe it instead
// of launching it.
struct QCall {
  const bf16 *x, *wq, *k, *v;
  bf16* o;
  int B, N, C, H, S;
  float scale_log2;
  cudaStream_t stream;
  int* info;
};

template <int HDP>
cudaError_t q_call(const QCall& a) {
  using Cfg = QAttn<HDP>;
  static const cudaError_t err = cudaFuncSetAttribute(   // above 48 KB; set once
      cross_q_attn_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, (a.N + Cfg::Gemm::BM - 1) / Cfg::Gemm::BM, a.B);
  if (a.info)
    return describe_kernel<typename Cfg::Gemm>(cross_q_attn_kernel<HDP>, Cfg::SMEM, grid, a.info);
  cross_q_attn_kernel<HDP><<<grid, Cfg::Gemm::NTHREADS, Cfg::SMEM, a.stream>>>(
      a.x, a.wq, a.k, a.v, a.o, a.N, a.C, a.H, a.S, a.scale_log2);
  return cudaGetLastError();
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

// More than 48 KB of dynamic shared memory; set once.
cudaError_t out_smem_limit() {
  static const cudaError_t err = cudaFuncSetAttribute(
      cross_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Out::SMEM);
  return err;
}

dim3 out_grid(int M, int C) {
  return dim3((C + Out::BN - 1) / Out::BN, (M + Out::BM - 1) / Out::BM);
}

bool shapes_ok(int B, int N, int C, int H, int S) {
  return B > 0 && N > 0 && C > 0 && C % 16 == 0 && H > 0 && C % H == 0 && C / H <= 160 &&
         S > 0 && S <= SKP;
}

}  // namespace

// Returns a cudaError_t code: 0 when both launches were accepted. o is the
// [B, N, C] bf16 scratch for the concatenated heads; the two kernels run on
// `stream` back to back.
extern "C" int fused_cross_attention_fwd(const void* x, const void* wq, const void* k,
                                         const void* v, const void* wo, const void* bo, void* o,
                                         void* out, int B, int N, int C, int H, int S,
                                         float scale, void* stream) {
  if (!shapes_ok(B, N, C, H, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QCall a{static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
                static_cast<const bf16*>(k),  static_cast<const bf16*>(v),
                static_cast<bf16*>(o),        B, N, C, H, S, scale * kLog2e, st, nullptr};
  cudaError_t err = q_dispatch(a);
  if (err != cudaSuccess) return (int)err;
  err = out_smem_limit();
  if (err != cudaSuccess) return (int)err;
  cross_out_kernel<<<out_grid(B * N, C), Out::NTHREADS, Out::SMEM, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(wo), static_cast<const float*>(bo),
      static_cast<bf16*>(out), B * N, C);
  return (int)cudaGetLastError();
}

// Fills info[0..6] for cross_q_attn_kernel and info[7..13] for
// cross_out_kernel at these shapes (77 keys): registers a thread, shared
// memory a block (bytes), rows and columns a tile (the q kernel's columns are
// one head's, padded), resident blocks an SM, blocks in the grid, local
// memory a thread (bytes).
extern "C" int fused_cross_describe(int B, int N, int C, int H, int* info) {
  if (!shapes_ok(B, N, C, H, 77)) return (int)cudaErrorInvalidValue;
  const QCall a{nullptr, nullptr, nullptr, nullptr, nullptr, B, N, C, H, 77, 0.f, nullptr, info};
  cudaError_t err = q_dispatch(a);
  if (err != cudaSuccess) return (int)err;
  err = out_smem_limit();
  if (err != cudaSuccess) return (int)err;
  return (int)describe_kernel<Out>(cross_out_kernel, Out::SMEM, out_grid(B * N, C), info + 7);
}
