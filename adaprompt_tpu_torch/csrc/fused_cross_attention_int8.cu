// w8a8 fused cross-attention for Hopper (sm_90a), forward only: for a tile
// of rows of x,
//   x_q, xs = quant_row(x);  q = bf16(int(x_q . Wq_q^T) * xs * sq)
//   per head h: o_h = softmax(q_h . k_h^T * scale) . v_h   (p rounded to bf16)
//   o = concat_h(o_h) in fp32;  o_q, os = quant_row(o)
//   out = int(o_q . Wo_q^T) * os * so + bo
// with quant_row(v) = (clip(rint(v / sc), -127, 127), sc = max|v| / 127 + 1e-8)
// per row, rounding half to even as jnp.round does. q, the head concat
// and its int8 copy stay in shared memory: only x and out touch device
// memory besides the int8 weights and the tiny 77-token K/V.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fused_cross_i8_kernel
// (launched from fused_cross_attention_int8). Layouts: x [B, N, C] bf16;
// Wq_q, Wo_q [C, C] int8 in PyTorch's [out, in] layout with per-output-
// channel scales sq, so [C] f32 (quant.quantize_weight); k/v [B, S, H, hd]
// bf16 as unet.precompute_cross_kv returns them (read with strides); bo [C]
// f32; out [B, N, C] bf16.
//
// What bounds it: the two C x C projections, 4*N*C^2 int8 operations per
// batch row, and the attention over S=77 keys, 4*N*S*C bf16 flops; bytes
// are x in and out (4*N*C per batch row) plus 2*C^2 of int8 weights. At
// C=320 that sits near the H100's ridge point.
//
// Design: the bf16 kernel (csrc/fused_cross_attention.cu) with both
// projections on the int8 tensor cores (mma.sync m16n8k32, s8 x s8 -> s32;
// A fragments from int8 tiles in shared memory, rows padded by 16 bytes;
// B fragments as 32-bit words straight from the weights in L2; a warp owns
// 16x8 output tiles) and two differences the int8 path needs: the head
// concat o is kept in fp32 (the TPU kernel concatenates fp32 heads), and it
// is quantized per row across all heads before the out-projection. The
// attention itself is bf16 WMMA with fp32 sums, as in the bf16 kernel: the
// 77 keys are padded to 80 with -inf scores, hd=40 to 48 with zeros. The
// scales are true divisions and the dequantizations use explicitly rounded
// multiplies and adds (no FMA), as the plain version's tensor operations
// round, so that from the same input the int8 x and q equal the plain
// version's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 16;            // bytes added to each int8 row
constexpr int MAX_SMEM = 232448;   // a block's shared memory on sm_90

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Layout {          // shared-memory carve-up, byte offsets (128-aligned)
  int xq, qs, of, qh, kh, vh, ps, ss, xs, os, total;
  __host__ __device__ Layout(int tm, int C, int hdp, int sp) {
    int off = 0;
    xq = off; off += round_up(tm * (C + PAD), 128);             // int8 x, later int8 o
    qs = off; off += round_up(tm * C * 2, 128);                 // bf16 x tile, then q
    of = off; off += round_up(tm * C * 4, 128);                 // fp32 concat(o_h)
    qh = off; off += round_up(tm * hdp * 2, 128);               // q of one head, padded
    kh = off; off += round_up(sp * hdp * 2, 128);               // k of one head, padded
    vh = off; off += round_up(sp * hdp * 2, 128);               // v of one head, padded
    ps = off; off += round_up(tm * sp * 2, 128);                // probabilities (bf16)
    ss = off; off += round_up(tm * (sp > hdp ? sp : hdp) * 4, 128);  // scores, then o_h (f32)
    xs = off; off += round_up(tm * 4, 128);                     // per-row scale of x
    os = off; off += round_up(tm * 4, 128);                     // per-row scale of o
    total = off;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// acc = A[16, K] . W[n0:n0+8, 0:K]^T; A int8 in shared memory (row stride
// lda), W int8 [*, K] in global memory
__device__ __forceinline__ void tile_s8(int (&acc)[4], const int8_t* A, int lda,
                                        const int8_t* __restrict__ w, int n0, int K, int lane) {
  const int8_t* ar = A + (lane >> 2) * lda + (lane & 3) * 4;
  const int8_t* wr = w + (long)(n0 + (lane >> 2)) * K + (lane & 3) * 4;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 32) {
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ar + k0),
                           *reinterpret_cast<const uint32_t*>(ar + 8 * lda + k0),
                           *reinterpret_cast<const uint32_t*>(ar + k0 + 16),
                           *reinterpret_cast<const uint32_t*>(ar + 8 * lda + k0 + 16)};
    mma_s8(acc, a, __ldg(reinterpret_cast<const unsigned int*>(wr + k0)),
           __ldg(reinterpret_cast<const unsigned int*>(wr + k0 + 16)));
  }
}

// (acc * row scale) * column scale, each rounded on its own
__device__ __forceinline__ float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(NTHREADS)
fused_cross_int8_kernel(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ wq, const float* __restrict__ sq,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int8_t* __restrict__ wo, const float* __restrict__ so,
                        const float* __restrict__ bo, __nv_bfloat16* __restrict__ out,
                        int N, int C, int H, int S, int tm, float scale) {
  const int hd = C / H, hdp = round_up(hd, 16), sp = round_up(S, 16);
  const Layout L(tm, C, hdp, sp);
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Xq = reinterpret_cast<int8_t*>(smem + L.xq);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.qs);
  float* Of = reinterpret_cast<float*>(smem + L.of);
  __nv_bfloat16* Qh = reinterpret_cast<__nv_bfloat16*>(smem + L.qh);
  __nv_bfloat16* Kh = reinterpret_cast<__nv_bfloat16*>(smem + L.kh);
  __nv_bfloat16* Vh = reinterpret_cast<__nv_bfloat16*>(smem + L.vh);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L.ps);
  float* Ss = reinterpret_cast<float*>(smem + L.ss);
  float* Xs = reinterpret_cast<float*>(smem + L.xs);
  float* Os = reinterpret_cast<float*>(smem + L.os);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ldq = C + PAD;
  const int rtiles = tm / 16, ctiles = C / 8;
  const int g_r = lane >> 2, g_c = (lane & 3) * 2;

  // x tile into Qs (rows past N are zero), then its int8 copy
  const int b = blockIdx.y, n0 = blockIdx.x * tm;
  const __nv_bfloat16* xb = x + ((long)b * N + n0) * C;
  const int chunks = C / 8;
  for (int i = tid; i < tm * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n0 + r < N) val = *reinterpret_cast<const uint4*>(xb + (long)r * C + c);
    *reinterpret_cast<uint4*>(Qs + r * C + c) = val;
  }
  __syncthreads();
  for (int r = warp; r < tm; r += NWARPS) {
    float mx = 0.f;
    for (int c = lane; c < C; c += 32) mx = fmaxf(mx, fabsf(__bfloat162float(Qs[r * C + c])));
    const float sc = row_scale(warp_max(mx));
    if (lane == 0) Xs[r] = sc;
    for (int c = lane; c < C; c += 32) Xq[r * ldq + c] = quantize(__bfloat162float(Qs[r * C + c]), sc);
  }
  __syncthreads();

  // q = x_q . Wq_q^T, dequantized and rounded to bf16 (x's dtype)
  for (int t = warp; t < rtiles * ctiles; t += NWARPS) {
    const int rt = t / ctiles, c0 = (t % ctiles) * 8;
    int acc[4] = {0, 0, 0, 0};
    tile_s8(acc, Xq + rt * 16 * ldq, ldq, wq, c0, C, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rt * 16 + g_r + (i >> 1) * 8, c = c0 + g_c + (i & 1);
      Qs[r * C + c] = __float2bfloat16(dequant(acc[i], Xs[r], sq[c]));
    }
  }
  __syncthreads();

  const __nv_bfloat16* kbase = k + (long)b * S * C;   // [S, H, hd] of this batch row
  const __nv_bfloat16* vbase = v + (long)b * S * C;
  for (int h = 0; h < H; ++h) {
    for (int i = tid; i < sp * hdp; i += NTHREADS) {
      const int s = i / hdp, d = i % hdp;
      const bool ok = s < S && d < hd;
      Kh[i] = ok ? kbase[(long)s * C + h * hd + d] : __float2bfloat16(0.f);
      Vh[i] = ok ? vbase[(long)s * C + h * hd + d] : __float2bfloat16(0.f);
    }
    for (int i = tid; i < tm * hdp; i += NTHREADS) {
      const int r = i / hdp, d = i % hdp;
      Qh[i] = d < hd ? Qs[r * C + h * hd + d] : __float2bfloat16(0.f);
    }
    __syncthreads();

    // scores [tm, sp] = q_h . k_h^T (fp32 sums)
    const int stiles = sp / 16;
    for (int t = warp; t < rtiles * stiles; t += NWARPS) {
      const int rt = t / stiles, ct = t % stiles;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < hdp; kk += 16) {
        FragA fa;
        FragBc fb;
        wmma::load_matrix_sync(fa, Qh + rt * 16 * hdp + kk, hdp);
        wmma::load_matrix_sync(fb, Kh + ct * 16 * hdp + kk, hdp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + rt * 16 * sp + ct * 16, acc, sp, wmma::mem_row_major);
    }
    __syncthreads();

    // softmax over the S keys of each row: exp(s - max) / sum (padded keys -> 0)
    for (int r = warp; r < tm; r += NWARPS) {
      float* srow = Ss + r * sp;
      float mx = -INFINITY;
      for (int c = lane; c < S; c += 32) mx = fmaxf(mx, srow[c] * scale);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int c = lane; c < S; c += 32) {
        const float p = expf(srow[c] * scale - mx);
        srow[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < sp; c += 32)
        Ps[r * sp + c] = __float2bfloat16(c < S ? __fdiv_rn(srow[c], sum) : 0.f);
    }
    __syncthreads();

    // o_h [tm, hdp] = p . v_h, staged in Ss (f32), then into the fp32 concat
    const int dtiles = hdp / 16;
    for (int t = warp; t < rtiles * dtiles; t += NWARPS) {
      const int rt = t / dtiles, ct = t % dtiles;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < sp; kk += 16) {
        FragA fa;
        FragBr fb;
        wmma::load_matrix_sync(fa, Ps + rt * 16 * sp + kk, sp);
        wmma::load_matrix_sync(fb, Vh + kk * hdp + ct * 16, hdp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + rt * 16 * hdp + ct * 16, acc, hdp, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < tm * hd; i += NTHREADS) {
      const int r = i / hd, d = i % hd;
      Of[r * C + h * hd + d] = Ss[r * hdp + d];
    }
    __syncthreads();
  }

  // the fp32 concat quantized per row across all heads (into Xq's space)
  for (int r = warp; r < tm; r += NWARPS) {
    float mx = 0.f;
    for (int c = lane; c < C; c += 32) mx = fmaxf(mx, fabsf(Of[r * C + c]));
    const float sc = row_scale(warp_max(mx));
    if (lane == 0) Os[r] = sc;
    for (int c = lane; c < C; c += 32) Xq[r * ldq + c] = quantize(Of[r * C + c], sc);
  }
  __syncthreads();

  // out = o_q . Wo_q^T, dequantized, + bo
  __nv_bfloat16* ob = out + ((long)b * N + n0) * C;
  for (int t = warp; t < rtiles * ctiles; t += NWARPS) {
    const int rt = t / ctiles, c0 = (t % ctiles) * 8;
    int acc[4] = {0, 0, 0, 0};
    tile_s8(acc, Xq + rt * 16 * ldq, ldq, wo, c0, C, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rt * 16 + g_r + (i >> 1) * 8, c = c0 + g_c + (i & 1);
      if (n0 + r < N)
        ob[(long)r * C + c] = __float2bfloat16(__fadd_rn(dequant(acc[i], Os[r], so[c]), bo[c]));
    }
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int fused_cross_attention_int8_fwd(const void* x, const void* wq, const void* sq,
                                              const void* k, const void* v, const void* wo,
                                              const void* so, const void* bo, void* out,
                                              int B, int N, int C, int H, int S,
                                              float scale, void* stream) {
  if (C % 32 != 0 || H <= 0 || C % H != 0 || (C / H) % 8 != 0 || S <= 0 || N <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const int tm = C <= 640 ? 32 : 16;
  const Layout L(tm, C, round_up(C / H, 16), round_up(S, 16));
  if (L.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_cross_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + tm - 1) / tm, B);
  fused_cross_int8_kernel<<<grid, NTHREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sq), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int8_t*>(wo),
      static_cast<const float*>(so), static_cast<const float*>(bo),
      static_cast<__nv_bfloat16*>(out), N, C, H, S, tm, scale);
  return (int)cudaGetLastError();
}
