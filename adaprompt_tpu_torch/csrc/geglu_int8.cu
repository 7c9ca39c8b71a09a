// w8a8 fused GEGLU feed-forward for Hopper (sm_90a), forward only:
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
// What bounds it: 24*M*C^2 int8 operations (F = 4C) against 4*M*C bytes
// of activations plus 12*C^2 bytes of int8 weights: far above the H100's
// ridge point, so the tensor cores bound it (1979 TOPS int8 dense).
//
// Design. Unlike the bf16 kernel (csrc/geglu.cu), which folds each 64-wide
// chunk of g into the output as it goes, g must be quantized per row over
// all F columns before the second product can start, so a block holds the
// whole fp32 g of its rows in shared memory: tm x F floats (160 KB at
// tm=16, F=2560; tm=32 where it fits, i.e. C=320). g is quantized from that
// fp32 value, never from a bf16 copy. Both products use the int8 tensor
// cores through mma.sync m16n8k32 (s8 x s8 -> s32): A fragments from the
// int8 tiles in shared memory (rows padded by 16 bytes so the fragment
// loads hit distinct banks), B fragments read as 32-bit words straight from
// the weights in global memory (L2), each warp owning 16x8 output tiles.
// The int32 sums are exact; the scales are true divisions and the
// dequantization uses explicitly rounded multiplies and adds (no FMA
// contraction), as the plain version's separate tensor operations round,
// so that from the same input the int8 x and h equal the plain version's.
// A TMA/wgmma pipeline that stages the weights once per block is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 16;            // bytes added to each int8 row
constexpr int FPAD = 8;            // floats added to each row of g
constexpr int MAX_SMEM = 232448;   // a block's shared memory on sm_90

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Layout {          // shared-memory carve-up, byte offsets (128-aligned)
  int gf, gq, xq, xs, gs, total;
  __host__ __device__ Layout(int tm, int C, int F) {
    int off = 0;
    gf = off; off += round_up(tm * (F + FPAD) * 4, 128);   // fp32 g; first the bf16 x tile
    gq = off; off += round_up(tm * (F + PAD), 128);        // int8 g
    xq = off; off += round_up(tm * (C + PAD), 128);        // int8 x
    xs = off; off += round_up(tm * 4, 128);                // per-row scale of x
    gs = off; off += round_up(tm * 4, 128);                // per-row scale of g
    total = off;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_scale(float absmax) {
  return __fadd_rn(__fdiv_rn(absmax, 127.f), 1e-8f);
}

__device__ __forceinline__ int8_t quantize(float v, float sc) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, sc)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// c[16x8] += A[16x32] . B[32x8], int8 operands, int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [0,16), columns [0,32) of an int8 tile with row stride lda
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* A, int lda, int lane) {
  const int8_t* p = A + (lane >> 2) * lda + (lane & 3) * 4;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 16);
}

// acc = A[16, K] . W[n0:n0+8, 0:K]^T; A int8 in shared memory, W int8 [*, K] global
__device__ __forceinline__ void tile_s8(int (&acc)[4], const int8_t* A, int lda,
                                        const int8_t* __restrict__ w, int n0, int K, int lane) {
  const int8_t* wr = w + (long)(n0 + (lane >> 2)) * K + (lane & 3) * 4;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 32) {
    uint32_t a[4];
    load_a(a, A + k0, lda, lane);
    mma_s8(acc, a, __ldg(reinterpret_cast<const unsigned int*>(wr + k0)),
           __ldg(reinterpret_cast<const unsigned int*>(wr + k0 + 16)));
  }
}

// (acc * row scale) * column scale + bias, each rounded on its own
__device__ __forceinline__ float dequant(int acc, float rs, float cs, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs), bias);
}

__global__ void __launch_bounds__(NTHREADS)
geglu_int8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w1,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  const int8_t* __restrict__ w2, const float* __restrict__ s2,
                  const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                  int M, int C, int F, int tm) {
  const Layout L(tm, C, F);
  extern __shared__ __align__(128) unsigned char smem[];
  float* Gf = reinterpret_cast<float*>(smem + L.gf);
  int8_t* Gq = reinterpret_cast<int8_t*>(smem + L.gq);
  int8_t* Xq = reinterpret_cast<int8_t*>(smem + L.xq);
  float* Xs = reinterpret_cast<float*>(smem + L.xs);
  float* Gs = reinterpret_cast<float*>(smem + L.gs);
  __nv_bfloat16* Xb = reinterpret_cast<__nv_bfloat16*>(smem + L.gf);   // until g is written
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * tm;
  const int ldx = C + PAD, ldf = F + FPAD, ldg = F + PAD;
  const int rtiles = tm / 16;

  // x tile (rows past M are zero: their scale is 1e-8 and their values 0)
  const int chunks = C / 8;
  for (int i = tid; i < tm * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m0 + r < M) val = *reinterpret_cast<const uint4*>(x + (long)(m0 + r) * C + c);
    *reinterpret_cast<uint4*>(Xb + r * C + c) = val;
  }
  __syncthreads();
  for (int r = warp; r < tm; r += NWARPS) {
    float mx = 0.f;
    for (int c = lane; c < C; c += 32) mx = fmaxf(mx, fabsf(__bfloat162float(Xb[r * C + c])));
    const float sc = row_scale(warp_max(mx));
    if (lane == 0) Xs[r] = sc;
    for (int c = lane; c < C; c += 32) Xq[r * ldx + c] = quantize(__bfloat162float(Xb[r * C + c]), sc);
  }
  __syncthreads();

  // g [tm, F]: for each 16x8 tile, the a- and the gate-columns side by side
  const int g_r = lane >> 2, g_c = (lane & 3) * 2;
  const int ftiles = F / 8;
  for (int t = warp; t < rtiles * ftiles; t += NWARPS) {
    const int rt = t / ftiles, n0 = (t % ftiles) * 8;
    int acc_a[4] = {0, 0, 0, 0}, acc_g[4] = {0, 0, 0, 0};
    tile_s8(acc_a, Xq + rt * 16 * ldx, ldx, w1, n0, C, lane);
    tile_s8(acc_g, Xq + rt * 16 * ldx, ldx, w1, F + n0, C, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rt * 16 + g_r + (i >> 1) * 8, c = n0 + g_c + (i & 1);
      const float a = dequant(acc_a[i], Xs[r], s1[c], b1[c]);
      const float gt = dequant(acc_g[i], Xs[r], s1[F + c], b1[F + c]);
      Gf[r * ldf + c] = a * (gt * 0.5f * (1.f + erff(gt * 0.70710678118654752f)));
    }
  }
  __syncthreads();
  for (int r = warp; r < tm; r += NWARPS) {
    float mx = 0.f;
    for (int c = lane; c < F; c += 32) mx = fmaxf(mx, fabsf(Gf[r * ldf + c]));
    const float sc = row_scale(warp_max(mx));
    if (lane == 0) Gs[r] = sc;
    for (int c = lane; c < F; c += 32) Gq[r * ldg + c] = quantize(Gf[r * ldf + c], sc);
  }
  __syncthreads();

  // out [tm, C] = g_q . W2_q^T, dequantized
  const int ctiles = C / 8;
  for (int t = warp; t < rtiles * ctiles; t += NWARPS) {
    const int rt = t / ctiles, n0 = (t % ctiles) * 8;
    int acc[4] = {0, 0, 0, 0};
    tile_s8(acc, Gq + rt * 16 * ldg, ldg, w2, n0, F, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rt * 16 + g_r + (i >> 1) * 8, c = n0 + g_c + (i & 1);
      if (m0 + r < M)
        out[(long)(m0 + r) * C + c] = __float2bfloat16(dequant(acc[i], Gs[r], s2[c], b2[c]));
    }
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int geglu_int8_fwd(const void* x, const void* w1, const void* s1, const void* b1,
                              const void* w2, const void* s2, const void* b2, void* out,
                              int M, int C, int F, void* stream) {
  if (M <= 0 || C <= 0 || C % 32 != 0 || F <= 0 || F % 32 != 0)
    return (int)cudaErrorInvalidValue;
  int tm = 32;
  if (Layout(tm, C, F).total > MAX_SMEM) tm = 16;
  const Layout L(tm, C, F);
  if (L.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(geglu_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  geglu_int8_kernel<<<(M + tm - 1) / tm, NTHREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), M, C, F, tm);
  return (int)cudaGetLastError();
}
