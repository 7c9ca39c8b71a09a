// Fused GEGLU feed-forward for Hopper (sm_90a), as two block-GEMM kernels in
// one C call:
//   h = x . W1^T + b1;  (a, gate) = split(h);  g = a * gelu_erf(gate);
//   out = g . W2^T + b2
//
// Replaces the TPU kernel adaprompt_tpu/ops/geglu.py::_geglu_kernel (launched
// from _geglu_impl). Layouts: x [M, C] bf16; W1 [2F, C] and W2 [C, F] bf16 in
// PyTorch's [out, in] layout; b1 [2F], b2 [C] f32; out [M, C] bf16. h is summed
// in fp32; g is formed in fp32 with CUDA's exact erff and rounded to bf16; out
// is summed in fp32 and rounded to bf16: the rounding points of the TPU kernel
// (which used the Abramowitz-Stegun 7.1.26 erf, |err| < 1.5e-7).
//
// What bounds it: 6*M*C*F operations (F = 4C) against x, out, the weights and
// g's round trip (M*F bf16 written and read once): ~380 operations a byte at
// C=320, above the card's ridge of ~295, so the tensor cores bound it.
//
// Design. The TPU kernel keeps h and g in VMEM, which holds megabytes. On this
// card the one-kernel form has to hold the fp32 [rows, C] output sum in
// registers across the whole F loop; that caps the row tile at 32-64 rows, and
// every tile then re-reads all of W1 and W2 through L2 (1.26 GB a call at
// C=320, M=16384). So the call is split where both packages already round g
// to bf16, into two kernels on one block-GEMM main loop (BlockGemm of
// block_gemm.cuh: C = A.B^T with A [M, K] and B [N, K], K contiguous; a
// cp.async ring of A and B tiles 64 deep in K, rows padded to an odd number
// of 16-byte units so that ldmatrix is free of bank conflicts; ldmatrix
// fragments and mma.sync.m16n8k16 with fp32 sums, on the helpers of
// flash_sm90.cuh):
//   * geglu_proj_kernel computes a 128 x 128 tile of h with 8 warps (4 x 2).
//     Its 128 B rows are 64 rows of W1's a-half and the same 64 of its
//     gate-half, interleaved in groups of 32 (a, gate, a, gate), so that each
//     warp's n8 tiles come in (a, gate) pairs with the same column: every
//     thread holds a and gate of the same (row, column) in its accumulators.
//     The epilogue adds b1, forms g in fp32, rounds it to bf16 in registers,
//     stages the 128 x 64 g tile in the ring's shared memory (free after the
//     last k step) and writes it out in 16-byte row pieces to the scratch
//     g [M, F] bf16, which the wrapper allocates. Two blocks an SM, so that
//     one block's epilogue (exact erff over 32 values a thread) runs beside
//     the other's products.
//   * geglu_out_kernel computes a 128 x 160 tile of out = g . W2^T + b2
//     (K = F; C = 320 is two such tiles, C = 640 four) with 8 warps of 32 x 80,
//     one block an SM, staged and stored the same way. (A 128 x 64 tile, two
//     blocks an SM, was slower: each block re-reads its g rows and W2
//     through L2 for fewer columns.)
// The fp32 [M, 2F] h never leaves the chip. g (42 MB at C=320 M=16384) is
// written once and read once, mostly from the 50 MB L2: both grids put the
// column tiles of one row tile next to each other in launch order, so x's and
// g's rows are re-read while they are still in L2. Ragged edges: rows past M
// and 16-byte units past K are zero-filled by cp.async (both operands, so
// nothing but zeros meets them) and never stored; columns of out past C
// likewise. Not built: wgmma and TMA, a persistent grid whose next
// tile's loads overlap this tile's epilogue (the later steps for this kernel).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace block_gemm;
using namespace flash_sm90;
using bf16 = __nv_bfloat16;

// The tile shapes, the fastest of those timed on an H100 SXM (700 W) at C=320
// M=16384 and C=640 M=4096: for h, 128 x 128 with 8 or 4 warps, 128 x 256 and
// 256 x 128, 32 or 64 deep in K, 3 to 5 stages; for out, 128 x 64, 128 x 128,
// 64 x 64, 256 x 64, 64 x 160 and 128 x 160.
using Proj = BlockGemm<128, 128, 64, 4, 2, 3>;   // tiles of h: 64 g columns
using Out = BlockGemm<128, 160, 64, 4, 2, 4>;    // tiles of out
constexpr int PROJ_MIN_BLOCKS = 2, OUT_MIN_BLOCKS = 1;   // resident blocks an SM (launch bounds)
constexpr int GCOLS = Proj::BN / 2;                      // g columns a proj tile

__device__ __forceinline__ float geglu_value(float a, float gate) {
  return a * (0.5f * gate * (1.f + erff(gate * 0.70710678118654752f)));
}

// grid (F / GCOLS, ceil(M / BM)): g[m0:m0+BM, j0:j0+GCOLS] for j0 = GCOLS * blockIdx.x
__global__ void __launch_bounds__(Proj::NTHREADS, PROJ_MIN_BLOCKS)
geglu_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, bf16* __restrict__ g, int M, int C, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * GCOLS, m0 = blockIdx.y * Proj::BM;
  const int c = Proj::col_of(tid);
  Proj::ARows a;
#pragma unroll
  for (int i = 0; i < Proj::A_LOADS; ++i) {
    const int r = m0 + Proj::row_of(tid, i);
    a.ok[i] = r < M;
    a.src[i] = x + (long)(a.ok[i] ? r : 0) * C + c;
  }
  // B row r of the tile: group r / GRP of W1's a-half (even groups) or
  // gate-half (odd), column j0 + (r / (2 GRP)) * GRP + r % GRP of g
  constexpr int GRP = Proj::NT / 2 * 8;   // g columns a warp
  Proj::BRows b;
#pragma unroll
  for (int i = 0; i < Proj::B_LOADS; ++i) {
    const int r = Proj::row_of(tid, i);
    const int col = j0 + r / (2 * GRP) * GRP + r % GRP;
    b.ok[i] = true;
    b.src[i] = w1 + (long)((r / GRP) % 2 ? F + col : col) * C + c;
  }
  float acc[Proj::MT][Proj::NT][4];
  Proj::mainloop(acc, smem, a, b, C, tid);

  // n8 tile nt < NT/2 of a warp holds a at g columns wn*GRP + nt*8 + (0..7),
  // tile nt + NT/2 the gate at the same columns
  using T = Staging<Proj, GCOLS>;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / Proj::WN, wn = warp % Proj::WN, q = lane / 4, t = lane % 4;
  constexpr int HALF = Proj::NT / 2;
#pragma unroll
  for (int nt = 0; nt < HALF; ++nt) {
    const int col = wn * GRP + nt * 8 + 2 * t;
    const float ba0 = b1[j0 + col], ba1 = b1[j0 + col + 1];
    const float bg0 = b1[F + j0 + col], bg1 = b1[F + j0 + col + 1];
#pragma unroll
    for (int mt = 0; mt < Proj::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        T::put(smem, wm * Proj::MT * 16 + mt * 16 + q + 8 * h, col,
               geglu_value(acc[mt][nt][2 * h] + ba0, acc[mt][nt + HALF][2 * h] + bg0),
               geglu_value(acc[mt][nt][2 * h + 1] + ba1, acc[mt][nt + HALF][2 * h + 1] + bg1));
  }
  __syncthreads();
  T::store(g, F, m0, M, j0, F, smem, tid);
}

// grid (ceil(C / BN), ceil(M / BM)): out[m0:m0+BM, n0:n0+BN] for n0 = BN * blockIdx.x
__global__ void __launch_bounds__(Out::NTHREADS, OUT_MIN_BLOCKS)
geglu_out_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ out, int M, int C, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * Out::BN, m0 = blockIdx.y * Out::BM;
  const int c = Out::col_of(tid);
  Out::ARows a;
#pragma unroll
  for (int i = 0; i < Out::A_LOADS; ++i) {
    const int r = m0 + Out::row_of(tid, i);
    a.ok[i] = r < M;
    a.src[i] = g + (long)(a.ok[i] ? r : 0) * F + c;
  }
  Out::BRows b;
#pragma unroll
  for (int i = 0; i < Out::B_LOADS; ++i) {
    const int r = n0 + Out::row_of(tid, i);
    b.ok[i] = r < C;
    b.src[i] = w2 + (long)(b.ok[i] ? r : 0) * F + c;
  }
  float acc[Out::MT][Out::NT][4];
  Out::mainloop(acc, smem, a, b, F, tid);

  using T = Staging<Out, Out::BN>;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / Out::WN, wn = warp % Out::WN, q = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < Out::NT; ++nt) {
    const int col = wn * Out::NT * 8 + nt * 8 + 2 * t;
    const bool ok = n0 + col < C;        // C even: col + 1 too
    const float bb0 = ok ? b2[n0 + col] : 0.f, bb1 = ok ? b2[n0 + col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < Out::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        T::put(smem, wm * Out::MT * 16 + mt * 16 + q + 8 * h, col,
               acc[mt][nt][2 * h] + bb0, acc[mt][nt][2 * h + 1] + bb1);
  }
  __syncthreads();
  T::store(out, C, m0, M, n0, C, smem, tid);
}

// Both kernels take more than 48 KB of dynamic shared memory; set once.
cudaError_t set_smem_limits() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(geglu_proj_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Proj::SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(geglu_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Out::SMEM);
  }();
  return err;
}

bool shapes_ok(int M, int C, int F) {
  return M > 0 && C > 0 && C % 16 == 0 && F > 0 && F % GCOLS == 0;
}

dim3 proj_grid(int M, int F) { return dim3(F / GCOLS, (M + Proj::BM - 1) / Proj::BM); }
dim3 out_grid(int M, int C) {
  return dim3((C + Out::BN - 1) / Out::BN, (M + Out::BM - 1) / Out::BM);
}

template <class Gemm, class Kernel>
cudaError_t describe_one(Kernel kernel, dim3 grid, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, Gemm::NTHREADS,
                                                      Gemm::SMEM);
  info[0] = attr.numRegs;
  info[1] = Gemm::SMEM;
  info[2] = Gemm::BM;
  info[3] = Gemm::BN;
  info[4] = blocks;
  info[5] = (int)(grid.x * grid.y);
  info[6] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace

// Returns a cudaError_t code: 0 when both launches were accepted. g is the
// [M, F] bf16 scratch for the gated intermediate; the two kernels run on
// `stream` back to back.
extern "C" int geglu_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* g, void* out, int M, int C, int F, void* stream) {
  if (!shapes_ok(M, C, F)) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_limits();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  geglu_proj_kernel<<<proj_grid(M, F), Proj::NTHREADS, Proj::SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<bf16*>(g), M, C, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  geglu_out_kernel<<<out_grid(M, C), Out::NTHREADS, Out::SMEM, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<bf16*>(out), M, C, F);
  return (int)cudaGetLastError();
}

// Fills info[0..6] for geglu_proj_kernel and info[7..13] for geglu_out_kernel
// at these shapes: registers a thread, shared memory a block (bytes), rows and
// columns a tile (the proj tile's columns are h's: half a, half the gate),
// resident blocks an SM, blocks in the grid, local memory a thread (bytes).
extern "C" int geglu_describe(int M, int C, int F, int* info) {
  if (!shapes_ok(M, C, F)) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_limits();
  if (err != cudaSuccess) return (int)err;
  err = describe_one<Proj>(geglu_proj_kernel, proj_grid(M, F), info);
  if (err != cudaSuccess) return (int)err;
  return (int)describe_one<Out>(geglu_out_kernel, out_grid(M, C), info + 7);
}
