// w8a8 fused GEGLU feed-forward for Hopper (sm_90a), forward only, as four
// kernels in one C call:
//   x_q, xs = quant_row(x);  h = int(x_q . W1_q^T) * xs * s1 + b1   (fp32)
//   (a, gate) = split(h);  g = a * gelu_erf(gate)                      (fp32)
//   g_q, gs = quant_row(g);  out = int(g_q . W2_q^T) * gs * s2 + b2
// with quant_row(v) = (clip(rint(v / sc), -127, 127), sc = max|v| / 127 + 1e-8)
// per row, rounding half to even from the fp32 value, as jnp.round does.
//
// Replaces the TPU kernel adaprompt_tpu/ops/geglu.py::_geglu_i8_kernel
// (launched from geglu_int8). Layouts: x [M, C] bf16; W1_q [2F, C] and
// W2_q [C, F] int8 in PyTorch's [out, in] layout with their per-output-
// channel scales s1 [2F], s2 [C] f32 (quant.quantize_weight); b1 [2F],
// b2 [C] f32; out [M, C] bf16.
//
// What bounds it: 6*M*C*F int8 operations (F = 4C) against x, out and the
// int8 weights: ~1,700 operations a byte at C=320 M=8192, far above the
// card's int8 ridge (~590), so the tensor cores bound the function (1979
// TOPS int8 dense). The split below adds g's fp32 round trip and g_q's
// (~105 MB at the main shapes, ~0.03 ms at the rate of device memory, which
// the g pass runs at): that is what the split costs.
//
// Why it splits at g's quantization. The TPU kernel keeps h and g of its
// rows in VMEM. Here one kernel would have to hold a row's whole fp32 g
// before quantizing it, since g's scale is the maximum over all F columns
// (42 MB of g at C=320 M=8192): a block could hold it for 16-32 rows only,
// and every such block re-read all of W1_q and W2_q from L2. So the call is
// split where the packages themselves take that maximum, into two products
// on one int8 block-GEMM (BlockGemmS8 of block_gemm.cuh: a cp.async ring of
// A and B tiles 128 bytes deep in K, rows padded to an odd number of 16-byte
// units, ldmatrix fragments and mma.sync.m16n8k32 s8 x s8 -> s32) and two
// row passes:
//   * geglu_int8_quant_x_kernel: x_q [M, C] int8 and xs [M], a warp a row;
//   * geglu_int8_proj_kernel: a 128 x 128 tile of h = x_q . W1_q^T (K = C),
//     its B rows W1_q's a- and gate-halves interleaved in groups of 32, as
//     geglu.cu's proj kernel has them, so that each thread holds a and gate
//     of the same (row, column); the epilogue dequantizes, forms g in fp32,
//     writes it to a g [M, F] fp32 scratch and each warp's max|g| of each
//     row over its 32 columns to pmax [M, F / 32]. Two blocks an SM, so that
//     one block's erff epilogue runs beside the other's products;
//   * geglu_int8_quant_g_kernel: gs from the row's F / 32 partial maxima
//     (max is exact in any order, and nothing needs zeroing between calls),
//     then g_q [M, F] int8 from g read in 16-byte units, a warp a row;
//   * geglu_int8_out_kernel: a 128 x 160 tile of out = g_q . W2_q^T (K = F),
//     one block an SM, or 64 x 160, two an SM, where the 128-row grid would
//     leave more than half the SMs idle (the serving stack's batch-2 steps);
//     dequantized, rounded to bf16, staged in the ring's shared memory and
//     stored in 16-byte row pieces.
// Both product grids put the column tiles of one row tile next to each other
// in launch order, so x_q's and g_q's rows are re-read while still in L2. The
// last three kernels are launched as programmatic dependents of the one
// before, which hides most of the gap between two launches. The row passes'
// bodies, the out kernel's and the launch are int8_rows.cuh's, which the
// int8 cross-attention (csrc/fused_cross_attention_int8.cu) shares.
//
// What bounds it on the card (tools/geglu_int8_tiles.py times each kernel):
// the proj kernel's epilogue (exact erff, two conversions and the dequant
// arithmetic for each of the M*F values of g: at C=640, with twice C=320's
// products, it takes ~0.02 ms more, so its fixed part at M*F = 10.5 M is the
// epilogue's), then the g pass, which moves g at the rate of device memory.
//
// Exactness. The int32 sums are exact; the scales are true divisions
// (__fdiv_rn), quantization rounds half to even (rintf) from the fp32 value,
// and the dequantization multiplies and adds are rounded each on its own
// (__fmul_rn, __fadd_rn: no FMA contraction), as the plain version's
// separate tensor operations round. So from the same input the int8 x, h, g
// and g's scale equal the plain version's, and g is never rounded to bf16.
// Ragged edges: rows past M and 16-byte units past K are zero-filled by
// cp.async in both operands and never stored; columns of out past C
// likewise. The wrapper gives one workspace (geglu_int8_workspace bytes) for
// x_q, xs, g, pmax, g_q and gs.
//
// Left for later: quantizing g inside the out kernel's staging (one fp32
// read of g, no g_q round trip: ~21 MB less traffic a call at the main
// shapes), wgmma with TMA, and a persistent grid whose next tile's loads
// overlap this tile's epilogue (one walking the proj tiles with the next
// tile's first k tiles in flight gained nothing measurable here).

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

using Proj = BlockGemmS8<128, 128, 128, 4, 2, 3>;   // tiles of h: 64 g columns
struct Out : BlockGemmS8<128, 160, 128, 4, 2, 4> {      // tiles of out
  static constexpr int MIN_BLOCKS = 1;                   // resident blocks an SM (launch bounds)
};
struct OutThin : BlockGemmS8<64, 160, 128, 4, 2, 3> {   // ... where Out's grid is thin
  static constexpr int MIN_BLOCKS = 2;
};
constexpr int PROJ_MIN_BLOCKS = 2;
constexpr int GCOLS = Proj::BN / 2;                      // g columns a proj tile
constexpr int GRP = Proj::NT / 2 * 8;                    // g columns a proj warp

__device__ __forceinline__ float geglu_value(float a, float gate) {
  return a * (gate * 0.5f * (1.f + erff(gate * 0.70710678118654752f)));
}

// The scratch carved out of the caller's workspace, byte offsets (256-aligned)
struct Workspace {
  size_t xq, xs, g, pmax, gq, gs, total;
  Workspace(int M, int C, int F) {
    size_t off = 0;
    auto take = [&off](size_t bytes) {
      const size_t at = off;
      off += (bytes + 255) / 256 * 256;
      return at;
    };
    xq = take((size_t)M * C);                  // x_q [M, C] int8
    xs = take((size_t)M * 4);                  // xs [M] f32
    g = take((size_t)M * F * 4);               // g [M, F] f32
    pmax = take((size_t)M * (F / GRP) * 4);    // max|g| a row a proj warp [M, F / GRP] f32
    gq = take((size_t)M * F);                  // g_q [M, F] int8
    gs = take((size_t)M * 4);                  // gs [M] f32
    total = off;
  }
};

// grid ceil(M / RWARPS), a warp a row: xs[r] = max|x[r]| / 127 + 1e-8,
// x_q[r] = quant(x[r], xs[r])
__global__ void __launch_bounds__(RWARPS * 32)
geglu_int8_quant_x_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                          float* __restrict__ xs, int M, int C) {
  quant_x_rows(x, xq, xs, M, C);
}

// grid (F / GCOLS, ceil(M / BM)): g[m0:m0+BM, j0:j0+GCOLS] in fp32 for
// j0 = GCOLS * blockIdx.x, and pmax[row][j0 / GRP + wn] = max|g| of the row
// over warp column wn's GRP columns
__global__ void __launch_bounds__(Proj::NTHREADS, PROJ_MIN_BLOCKS)
geglu_int8_proj_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                       const int8_t* __restrict__ w1, const float* __restrict__ s1,
                       const float* __restrict__ b1, float* __restrict__ g,
                       float* __restrict__ pmax, int M, int C, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * GCOLS, m0 = blockIdx.y * Proj::BM;
  const int c = Proj::col_of(tid);
  Proj::ARows a;
#pragma unroll
  for (int i = 0; i < Proj::A_LOADS; ++i) {
    const int r = m0 + Proj::row_of(tid, i);
    a.ok[i] = r < M;
    a.src[i] = xq + (long)(a.ok[i] ? r : 0) * C + c;
  }
  // B row r of the tile: group r / GRP of W1_q's a-half (even groups) or
  // gate-half (odd), column j0 + (r / (2 GRP)) * GRP + r % GRP of g
  Proj::BRows b;
#pragma unroll
  for (int i = 0; i < Proj::B_LOADS; ++i) {
    const int r = Proj::row_of(tid, i);
    const int col = j0 + r / (2 * GRP) * GRP + r % GRP;
    b.ok[i] = true;
    b.src[i] = w1 + (long)((r / GRP) % 2 ? F + col : col) * C + c;
  }
  wait_for_predecessor();                // x_q, xs
  int acc[Proj::MT][Proj::NT][4];
  Proj::mainloop(acc, smem, a, b, C, tid);

  // n8 tile nt < NT/2 of a warp holds a at g columns wn*GRP + nt*8 + (0..7),
  // tile nt + NT/2 the gate at the same columns
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / Proj::WN, wn = warp % Proj::WN, q = lane / 4, t = lane % 4;
  constexpr int HALF = Proj::NT / 2;
  int row[Proj::MT][2];
  float rs[Proj::MT][2], mx[Proj::MT][2];
#pragma unroll
  for (int mt = 0; mt < Proj::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[mt][h] = m0 + wm * Proj::MT * 16 + mt * 16 + q + 8 * h;
      rs[mt][h] = row[mt][h] < M ? xs[row[mt][h]] : 0.f;
      mx[mt][h] = 0.f;
    }
#pragma unroll
  for (int nt = 0; nt < HALF; ++nt) {
    const int col = j0 + wn * GRP + nt * 8 + 2 * t;
    const float sa0 = s1[col], sa1 = s1[col + 1], ba0 = b1[col], ba1 = b1[col + 1];
    const float sg0 = s1[F + col], sg1 = s1[F + col + 1];
    const float bg0 = b1[F + col], bg1 = b1[F + col + 1];
#pragma unroll
    for (int mt = 0; mt < Proj::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float r_s = rs[mt][h];
        const float g0 = geglu_value(dequant(acc[mt][nt][2 * h], r_s, sa0, ba0),
                                     dequant(acc[mt][nt + HALF][2 * h], r_s, sg0, bg0));
        const float g1 = geglu_value(dequant(acc[mt][nt][2 * h + 1], r_s, sa1, ba1),
                                     dequant(acc[mt][nt + HALF][2 * h + 1], r_s, sg1, bg1));
        mx[mt][h] = fmaxf(mx[mt][h], fmaxf(fabsf(g0), fabsf(g1)));
        if (row[mt][h] < M)
          *reinterpret_cast<float2*>(g + (long)row[mt][h] * F + col) = make_float2(g0, g1);
      }
  }
  const int np = F / GRP;
#pragma unroll
  for (int mt = 0; mt < Proj::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m = quad_max(mx[mt][h]);   // the quad's four lanes share the row
      if (t == 0 && row[mt][h] < M) pmax[(long)row[mt][h] * np + j0 / GRP + wn] = m;
    }
}

// grid ceil(M / RWARPS), a warp a row: gs[r] from the row's partial maxima,
// g_q[r] = quant(g[r], gs[r])
__global__ void __launch_bounds__(RWARPS * 32)
geglu_int8_quant_g_kernel(const float* __restrict__ g, const float* __restrict__ pmax,
                          int8_t* __restrict__ gq, float* __restrict__ gs, int M, int F) {
  wait_for_predecessor();                // g, pmax
  quant_partial_rows(g, pmax, F / GRP, gq, gs, M, F);
}

// grid (ceil(C / BN), ceil(M / BM)): out[m0:m0+BM, n0:n0+BN] for n0 = BN * blockIdx.x
template <class G>
__global__ void __launch_bounds__(G::NTHREADS, G::MIN_BLOCKS)
geglu_int8_out_kernel(const int8_t* __restrict__ gq, const float* __restrict__ gs,
                      const int8_t* __restrict__ w2, const float* __restrict__ s2,
                      const float* __restrict__ b2, bf16* __restrict__ out, int M, int C,
                      int F) {
  out_tile<G>(gq, gs, w2, s2, b2, out, M, C, F);
}

// What the launches need to know of the card, found once: the products'
// shared-memory limits set (they take more than 48 KB), and its SMs.
struct Card {
  cudaError_t err;
  int sms;
};

const Card& card() {
  static const Card c = [] {
    Card k{cudaSuccess, 0};
    int device = 0;
    k.err = cudaFuncSetAttribute(geglu_int8_proj_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Proj::SMEM);
    if (k.err == cudaSuccess)
      k.err = cudaFuncSetAttribute(geglu_int8_out_kernel<Out>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, Out::SMEM);
    if (k.err == cudaSuccess)
      k.err = cudaFuncSetAttribute(geglu_int8_out_kernel<OutThin>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, OutThin::SMEM);
    if (k.err == cudaSuccess) k.err = cudaGetDevice(&device);
    if (k.err == cudaSuccess)
      k.err = cudaDeviceGetAttribute(&k.sms, cudaDevAttrMultiProcessorCount, device);
    return k;
  }();
  return c;
}

bool shapes_ok(int M, int C, int F) {
  return M > 0 && C > 0 && C % 16 == 0 && F > 0 && F % GCOLS == 0;
}

dim3 proj_grid(int M, int F) { return dim3(F / GCOLS, (M + Proj::BM - 1) / Proj::BM); }

template <class G>
dim3 out_grid(int M, int C) {
  return dim3((C + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
}

// The out kernel takes 64-row tiles, two blocks an SM, where its 128-row
// grid would leave more than half the SMs idle: at C=320 M=4096 and C=640
// M=2048, the serving stack's cond-only steps.
bool out_thin(int M, int C) {
  const dim3 grid = out_grid<Out>(M, C);
  return 2 * (int)(grid.x * grid.y) <= card().sms;
}

template <class G>
cudaError_t launch_out(const int8_t* gq, const float* gs, const void* w2, const void* s2,
                       const void* b2, void* out, int M, int C, int F, cudaStream_t s) {
  return launch_after(geglu_int8_out_kernel<G>, out_grid<G>(M, C), G::NTHREADS, G::SMEM, s,
                      gq, gs, static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
                      static_cast<const float*>(b2), static_cast<bf16*>(out), M, C, F);
}

}  // namespace

// The bytes of the workspace geglu_int8_fwd takes at these shapes, into *bytes.
extern "C" int geglu_int8_workspace(int M, int C, int F, long long* bytes) {
  if (!shapes_ok(M, C, F)) return (int)cudaErrorInvalidValue;
  *bytes = (long long)Workspace(M, C, F).total;
  return 0;
}

// Returns a cudaError_t code: 0 when all four launches were accepted. The
// kernels run on `stream` back to back; `workspace` holds
// geglu_int8_workspace bytes, 256-byte aligned.
extern "C" int geglu_int8_fwd(const void* x, const void* w1, const void* s1, const void* b1,
                              const void* w2, const void* s2, const void* b2, void* out,
                              void* workspace, int M, int C, int F, void* stream) {
  if (!shapes_ok(M, C, F)) return (int)cudaErrorInvalidValue;
  if (card().err != cudaSuccess) return (int)card().err;
  const Workspace W(M, C, F);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  int8_t* xq = reinterpret_cast<int8_t*>(ws + W.xq);
  float* xs = reinterpret_cast<float*>(ws + W.xs);
  float* g = reinterpret_cast<float*>(ws + W.g);
  float* pmax = reinterpret_cast<float*>(ws + W.pmax);
  int8_t* gq = reinterpret_cast<int8_t*>(ws + W.gq);
  float* gs = reinterpret_cast<float*>(ws + W.gs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  geglu_int8_quant_x_kernel<<<rows_grid(M), RWARPS * 32, 0, s>>>(
      static_cast<const bf16*>(x), xq, xs, M, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = launch_after(geglu_int8_proj_kernel, proj_grid(M, F), Proj::NTHREADS, Proj::SMEM, s,
                     xq, xs, static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
                     static_cast<const float*>(b1), g, pmax, M, C, F);
  if (err != cudaSuccess) return (int)err;
  err = launch_after(geglu_int8_quant_g_kernel, rows_grid(M), RWARPS * 32, 0, s, g, pmax, gq,
                     gs, M, F);
  if (err != cudaSuccess) return (int)err;
  return (int)(out_thin(M, C) ? launch_out<OutThin>(gq, gs, w2, s2, b2, out, M, C, F, s)
                              : launch_out<Out>(gq, gs, w2, s2, b2, out, M, C, F, s));
}

// Fills info[7k..7k+6] for kernel k of the call in launch order (quant_x,
// proj, quant_g, out) at these shapes: registers a thread, shared memory a
// block (bytes), rows and columns a tile (the proj tile's columns are h's:
// half a, half the gate; a row pass's are a row's), resident blocks an SM,
// blocks in the grid, local memory a thread (bytes).
extern "C" int geglu_int8_describe(int M, int C, int F, int* info) {
  if (!shapes_ok(M, C, F)) return (int)cudaErrorInvalidValue;
  if (card().err != cudaSuccess) return (int)card().err;
  cudaError_t err =
      describe_one(geglu_int8_quant_x_kernel, RWARPS * 32, 0, RWARPS, C, rows_grid(M), info);
  if (err != cudaSuccess) return (int)err;
  err = describe_one(geglu_int8_proj_kernel, Proj::NTHREADS, Proj::SMEM, Proj::BM, Proj::BN,
                     proj_grid(M, F), info + 7);
  if (err != cudaSuccess) return (int)err;
  err = describe_one(geglu_int8_quant_g_kernel, RWARPS * 32, 0, RWARPS, F, rows_grid(M),
                     info + 14);
  if (err != cudaSuccess) return (int)err;
  if (out_thin(M, C))
    return (int)describe_one(geglu_int8_out_kernel<OutThin>, OutThin::NTHREADS, OutThin::SMEM,
                             OutThin::BM, OutThin::BN, out_grid<OutThin>(M, C), info + 21);
  return (int)describe_one(geglu_int8_out_kernel<Out>, Out::NTHREADS, Out::SMEM, Out::BM,
                           Out::BN, out_grid<Out>(M, C), info + 21);
}
