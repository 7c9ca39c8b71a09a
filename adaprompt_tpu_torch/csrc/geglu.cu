// Fused GEGLU feed-forward for Hopper (sm_90a):
//   h = x . W1^T + b1;  (a, gate) = split(h);  g = a * gelu_erf(gate);
//   out = g . W2^T + b2
// with the [M, 2F] projection and the [M, F] gated intermediate kept on
// chip: only x and out touch device memory besides the weights.
//
// Replaces the TPU kernel adaprompt_tpu/ops/geglu.py::_geglu_kernel
// (launched from _geglu_impl). Layouts: x [M, C] bf16; W1 [2F, C] and
// W2 [C, F] bf16 in PyTorch's [out, in] layout; b1 [2F], b2 [C] f32;
// out [M, C] bf16. GELU is the exact erf form with CUDA's erff (the TPU
// kernel used the Abramowitz-Stegun 7.1.26 approximation, |err| < 1.5e-7).
//
// What bounds it: 6*M*C*F flops (F = 4C: 24*M*C^2) against 4*M*C bytes of
// activations plus the weights, far above the H100's ridge point, so the
// tensor cores bound it. Design: one block of 8 warps per 32-row tile; it
// loops over F in 64-wide chunks, computes the a- and gate-chunk with bf16
// WMMA (fp32 accumulation), applies the gate in fp32, rounds g to bf16 (as
// the TPU kernel does) and accumulates g . W2-chunk^T into an fp32 [32, C]
// output held in registers (up to 10 16x16 fragments a warp, so C <= 640).
// Weight fragments are read straight from global memory (L2); a TMA/wgmma
// pipeline with larger row tiles, which cuts that weight re-reading, is
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 32;           // rows per block
constexpr int FC = 64;           // F chunk
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXT = 10;         // output fragments per warp: (TM/16)*(C/16)/NWARPS <= 10

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

size_t smem_bytes(int C) {
  return (size_t)TM * C * 2 + (size_t)TM * 2 * FC * 4 + (size_t)TM * FC * 2 +
         (size_t)NWARPS * 256 * 4;
}

__global__ void __launch_bounds__(NTHREADS)
geglu_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
             const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
             const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
             int M, int C, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);           // [TM][C]
  float* Hs = reinterpret_cast<float*>(Xs + TM * C);                     // [TM][2*FC]
  __nv_bfloat16* Gs = reinterpret_cast<__nv_bfloat16*>(Hs + TM * 2 * FC);  // [TM][FC]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* St = reinterpret_cast<float*>(Gs + TM * FC) + warp * 256;      // [16][16]

  const int m0 = blockIdx.x * TM;
  const int chunks = C / 8;
  for (int i = tid; i < TM * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m0 + r < M) val = *reinterpret_cast<const uint4*>(x + (long)(m0 + r) * C + c);
    *reinterpret_cast<uint4*>(Xs + r * C + c) = val;
  }
  __syncthreads();

  const int ctiles = C / 16;
  const int otiles = (TM / 16) * ctiles;
  constexpr int htiles_c = 2 * FC / 16;     // a and gate columns of one chunk
  FragC acc[MAXT];
#pragma unroll
  for (int i = 0; i < MAXT; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int j = 0; j < F; j += FC) {
    // h-chunk [TM, 2*FC]: columns [0, FC) are a[j:j+FC], [FC, 2FC) gate[j:j+FC]
    for (int t = warp; t < (TM / 16) * htiles_c; t += NWARPS) {
      const int rt = t / htiles_c, ct = t % htiles_c;
      const int wrow = ct < FC / 16 ? j + ct * 16 : F + j + (ct - FC / 16) * 16;
      FragC h;
      wmma::fill_fragment(h, 0.f);
      for (int kk = 0; kk < C; kk += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, Xs + rt * 16 * C + kk, C);
        wmma::load_matrix_sync(fb, w1 + (long)wrow * C + kk, C);
        wmma::mma_sync(h, fa, fb, h);
      }
      wmma::store_matrix_sync(Hs + rt * 16 * 2 * FC + ct * 16, h, 2 * FC, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < TM * FC; i += NTHREADS) {
      const int r = i / FC, c = i % FC;
      const float a = Hs[r * 2 * FC + c] + b1[j + c];
      const float gt = Hs[r * 2 * FC + FC + c] + b1[F + j + c];
      const float g = a * (0.5f * gt * (1.f + erff(gt * 0.70710678118654752f)));
      Gs[i] = __float2bfloat16(g);
    }
    __syncthreads();
    // out[TM, C] += g-chunk . W2[:, j:j+FC]^T
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      const int t = warp + i * NWARPS;
      if (t < otiles) {
        const int rt = t / ctiles, ct = t % ctiles;
#pragma unroll
        for (int kk = 0; kk < FC; kk += 16) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, Gs + rt * 16 * FC + kk, FC);
          wmma::load_matrix_sync(fb, w2 + (long)ct * 16 * F + j + kk, F);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
    // the next chunk's Hs/Gs writes are each fenced by a __syncthreads
    // that every warp reaches only after finishing its reads above
  }

#pragma unroll
  for (int i = 0; i < MAXT; ++i) {
    const int t = warp + i * NWARPS;
    if (t < otiles) {
      const int rt = t / ctiles, ct = t % ctiles;
      wmma::store_matrix_sync(St, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16, c = ct * 16 + e % 16;
        if (m0 + r < M) out[(long)(m0 + r) * C + c] = __float2bfloat16(St[e] + b2[c]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int geglu_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int M, int C, int F, void* stream) {
  if (C % 16 != 0 || C <= 0 || (TM / 16) * (C / 16) > MAXT * NWARPS || F % FC != 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(geglu_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  geglu_kernel<<<(M + TM - 1) / TM, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), M, C, F);
  return (int)cudaGetLastError();
}
