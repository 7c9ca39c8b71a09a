// What the port's two w8a8 kernels share (the int8 fused GEGLU B6,
// csrc/geglu_int8.cu, and the int8 fused cross-attention B5,
// csrc/fused_cross_attention_int8.cu): the per-row quantization of their
// activations, the w8a8 out-projection on BlockGemmS8, and the programmatic
// dependent launch that chains a call's kernels.
//
//   quant_row(v) = (clip(rint(v / sc), -127, 127), sc = max|v| / 127 + 1e-8)
//
// per row, rounding half to even from the fp32 value, as jnp.round does; the
// scale is a true division (__fdiv_rn), and a dequantization's multiplies
// and add are rounded each on its own (__fmul_rn, __fadd_rn: no FMA
// contraction), as the plain versions' separate tensor operations round.
//   * quant_x_rows: a bf16 row (x) -> its int8 copy and scale;
//   * quant_partial_rows: an fp32 row whose maximum the kernel before took in
//     parts (B6's g over F / 32 warp columns, B5's head concat o over its H
//     heads) -> its int8 copy and scale: max is exact in any order, so the
//     partials need no zeroing between calls, unlike an atomicMax;
//     both with L lanes of a warp a row (B6: a warp a row);
//   * out_tile: one tile of out = int(a_q . W_q^T) * as * ws + bias, rounded
//     to bf16, staged in the drained ring and stored in 16-byte row pieces.
// Device bodies only: each kernel source wraps them in __global__ kernels of
// its own names, since profile_step files kernels by name. Header-only, on
// block_gemm.cuh; ops/cuda_build.py hashes it into the name of every library
// that includes it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "block_gemm.cuh"

namespace int8_rows {

using namespace block_gemm;
using namespace flash_sm90;
using bf16 = __nv_bfloat16;

constexpr int RWARPS = 8;                // warps a block of the row passes
constexpr int XU = 5;                    // units of a row a lane keeps in registers

// The max over each aligned group of L lanes (L a power of two <= 32)
template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_scale(float absmax) {
  return __fadd_rn(__fdiv_rn(absmax, 127.f), 1e-8f);
}

__device__ __forceinline__ uint32_t quantize(float v, float sc) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, sc)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

// four values quantized and packed, the first in the low byte
__device__ __forceinline__ uint32_t quantize4(float v0, float v1, float v2, float v3, float sc) {
  return quantize(v0, sc) | quantize(v1, sc) << 8 | quantize(v2, sc) << 16
         | quantize(v3, sc) << 24;
}

// (acc * row scale) * column scale, each rounded on its own
__device__ __forceinline__ float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

// ... + bias, rounded on its own
__device__ __forceinline__ float dequant(int acc, float rs, float cs, float bias) {
  return __fadd_rn(dequant(acc, rs, cs), bias);
}

// Programmatic dependent launch (sm_90): the kernels after a call's first
// are launched so that the card may set each up while its predecessor on the
// stream ends (launch_after); each waits for its predecessor's results before
// it reads them (without the launch attribute the wait does nothing). No
// kernel lets its successor start early: blocks placed early crowd onto the
// SMs that free up first.
__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// eight bf16 values of a 16-byte unit quantized, packed in 8 bytes
__device__ __forceinline__ uint2 quantize8(const uint4& v, float sc) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
  return make_uint2(quantize4(f[0], f[1], f[2], f[3], sc), quantize4(f[4], f[5], f[6], f[7], sc));
}

__device__ __forceinline__ float absmax8(const uint4& v, float mx) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fabsf(__bfloat162float(e[i])));
  return mx;
}

// A row pass gives each row L lanes of a warp (L = 8, 16 or 32), so that a
// warp takes 32 / L rows at once: where a row is short, more of its loads are
// in flight. Block b, warp w, lane group g of a grid rows_grid<L>(M) takes row
// (b * RWARPS + w) * (32 / L) + g; its lanes stride the row by L units.
template <int L>
__device__ __forceinline__ int pass_row() {
  return (blockIdx.x * RWARPS + threadIdx.x / 32) * (32 / L) + threadIdx.x % 32 / L;
}

template <int L = 32>
inline dim3 rows_grid(int M) {
  constexpr int ROWS = RWARPS * (32 / L);              // rows a block
  return dim3((M + ROWS - 1) / ROWS);
}

// The x pass, x [M, C] (C % 8 == 0): xs[r] = max|x[r]| / 127 + 1e-8, x_q[r] =
// quant(x[r], xs[r]). A lane holds its first XU 16-byte units of the row in
// registers (all of it up to C = L * 8 * XU) and reads the rest twice.
template <int L = 32>
__device__ __forceinline__ void quant_x_rows(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                                             float* __restrict__ xs, int M, int C) {
  const int lane = threadIdx.x % L, r = pass_row<L>();
  if (L == 32 && r >= M) return;         // the whole warp
  const int units = r < M ? C / 8 : 0;   // 8 values a 16-byte unit; none past M
  const uint4* src = reinterpret_cast<const uint4*>(x + (long)r * C);
  uint4 v[XU];
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < XU; ++i)
    if (lane + L * i < units) v[i] = src[lane + L * i];
#pragma unroll
  for (int i = 0; i < XU; ++i)
    if (lane + L * i < units) mx = absmax8(v[i], mx);
  for (int u = lane + L * XU; u < units; u += L) mx = absmax8(src[u], mx);
  const float sc = row_scale(group_max<L>(mx));
  if (lane == 0 && r < M) xs[r] = sc;
  uint2* dst = reinterpret_cast<uint2*>(xq + (long)r * C);
#pragma unroll
  for (int i = 0; i < XU; ++i)
    if (lane + L * i < units) dst[lane + L * i] = quantize8(v[i], sc);
  for (int u = lane + L * XU; u < units; u += L) dst[u] = quantize8(src[u], sc);
}

// The pass over an fp32 intermediate v [M, W] (W % 8 == 0) whose row maxima
// come as np partials a row, pmax [M, np]: vs[r] = max of the row's partials
// / 127 + 1e-8, v_q[r] = quant(v[r], vs[r]), v read in 16-byte units.
template <int L = 32>
__device__ __forceinline__ void quant_partial_rows(const float* __restrict__ v,
                                                   const float* __restrict__ pmax, int np,
                                                   int8_t* __restrict__ vq,
                                                   float* __restrict__ vs, int M, int W) {
  const int lane = threadIdx.x % L, r = pass_row<L>();
  if (L == 32 && r >= M) return;         // the whole warp
  float mx = 0.f;
  for (int p = lane; p < (r < M ? np : 0); p += L) mx = fmaxf(mx, pmax[(long)r * np + p]);
  const float sc = row_scale(group_max<L>(mx));
  if (lane == 0 && r < M) vs[r] = sc;
  const float4* src = reinterpret_cast<const float4*>(v + (long)r * W);
  uint2* dst = reinterpret_cast<uint2*>(vq + (long)r * W);
  const int units = r < M ? W / 8 : 0;   // 8 values: two 16-byte reads, one 8-byte write
  for (int u = lane; u < units; u += L) {
    const float4 v0 = src[2 * u], v1 = src[2 * u + 1];
    dst[u] = make_uint2(quantize4(v0.x, v0.y, v0.z, v0.w, sc),
                        quantize4(v1.x, v1.y, v1.z, v1.w, sc));
  }
}

// One G::BM x G::BN tile of out [M, N] = int(a_q . w_q^T) * as * ws + bias
// in bf16, at rows m0 = G::BM * blockIdx.y and columns n0 = G::BN *
// blockIdx.x: a_q [M, K] int8 with row scales as [M], w_q [N, K] int8 with
// column scales ws [N] and bias [N] (N even). Waits for its predecessor
// before it reads a_q and as.
template <class G>
__device__ __forceinline__ void out_tile(const int8_t* __restrict__ aq,
                                         const float* __restrict__ as,
                                         const int8_t* __restrict__ w,
                                         const float* __restrict__ ws,
                                         const float* __restrict__ bias,
                                         bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM;
  const int c = G::col_of(tid);
  typename G::ARows a;
#pragma unroll
  for (int i = 0; i < G::A_LOADS; ++i) {
    const int r = m0 + G::row_of(tid, i);
    a.ok[i] = r < M;
    a.src[i] = aq + (long)(a.ok[i] ? r : 0) * K + c;
  }
  typename G::BRows b;
#pragma unroll
  for (int i = 0; i < G::B_LOADS; ++i) {
    const int r = n0 + G::row_of(tid, i);
    b.ok[i] = r < N;
    b.src[i] = w + (long)(b.ok[i] ? r : 0) * K + c;
  }
  wait_for_predecessor();                // a_q, as
  int acc[G::MT][G::NT][4];
  G::mainloop(acc, smem, a, b, K, tid);

  using T = Staging<G, G::BN>;
  bf16* Ts = reinterpret_cast<bf16*>(smem_raw);
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / G::WN, wn = warp % G::WN, q = lane / 4, t = lane % 4;
  float rs[G::MT][2];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * G::MT * 16 + mt * 16 + q + 8 * h;
      rs[mt][h] = r < M ? as[r] : 0.f;
    }
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
    const int col = wn * G::NT * 8 + nt * 8 + 2 * t;
    const bool ok = n0 + col < N;        // N even: col + 1 too
    const float cs0 = ok ? ws[n0 + col] : 0.f, cs1 = ok ? ws[n0 + col + 1] : 0.f;
    const float bb0 = ok ? bias[n0 + col] : 0.f, bb1 = ok ? bias[n0 + col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        T::put(Ts, wm * G::MT * 16 + mt * 16 + q + 8 * h, col,
               dequant(acc[mt][nt][2 * h], rs[mt][h], cs0, bb0),
               dequant(acc[mt][nt][2 * h + 1], rs[mt][h], cs1, bb1));
  }
  __syncthreads();
  T::store(out, N, m0, M, n0, N, Ts, tid);
}

// A launch that may overlap its predecessor's end
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                         cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// info[0..6]: registers a thread, shared memory a block (bytes), rows and
// columns a tile, resident blocks an SM, blocks in the grid, local memory a
// thread (bytes)
template <class Kernel>
cudaError_t describe_one(Kernel kernel, int threads, int smem, int rows, int cols, dim3 grid,
                         int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  info[0] = attr.numRegs;
  info[1] = smem;
  info[2] = rows;
  info[3] = cols;
  info[4] = blocks;
  info[5] = (int)(grid.x * grid.y * grid.z);
  info[6] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace int8_rows
