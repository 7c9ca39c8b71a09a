// Fused cross-attention for Hopper (sm_90a): for a tile of rows of x,
//   q = x . Wq^T;  per head h: o_h = softmax(q_h . k_h^T * scale) . v_h;
//   out = concat_h(o_h) . Wo^T + bo
// with q and the concatenated o kept in shared memory: only x and out touch
// device memory besides the weights and the tiny 77-token K/V.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fused_cross_kernel
// (launched from fused_cross_attention). Layouts: x [B, N, C] bf16; Wq, Wo
// [C, C] bf16 in PyTorch's [out, in] layout; k/v [B, S, H, hd] bf16 exactly
// as unet.precompute_cross_kv returns them (read with strides, no
// transpose); bo [C] f32; out [B, N, C] bf16.
//
// What bounds it: the two C x C projections (4*N*C*C flops per batch row)
// dominate the flops; the attention over S=77 keys adds 4*N*S*C. Bytes are
// x in and out once (2*N*C bf16 values per batch) plus the weights, which
// every block re-reads from L2. At C=320 the work sits near the H100's
// ridge point, so both bounds are close; the design removes the three
// [B, N, C] round trips of the unfused chain (q, the attention output, and
// the pre-projection concat). This first kernel reads weight fragments
// straight from global memory (L2) with WMMA; staging them through shared
// memory with TMA/wgmma is later work.
//
// Softmax: S=77 keys are padded to a multiple of 16 in shared memory; the
// padded keys get a score of -inf, so they add nothing to the row sum.
// hd=40 is padded to 48 the same way (zero columns in shared memory).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Layout {          // shared-memory carve-up, byte offsets (128-aligned)
  int xs, qs, qh, kh, vh, ps, ss, st, total;
  __host__ __device__ Layout(int tm, int C, int hdp, int sp) {
    int off = 0;
    xs = off; off += round_up(tm * C * 2, 128);                 // x tile, later concat(o_h)
    qs = off; off += round_up(tm * C * 2, 128);                 // q tile
    qh = off; off += round_up(tm * hdp * 2, 128);               // q of one head, padded
    kh = off; off += round_up(sp * hdp * 2, 128);               // k of one head, padded
    vh = off; off += round_up(sp * hdp * 2, 128);               // v of one head, padded
    ps = off; off += round_up(tm * sp * 2, 128);                // probabilities (bf16)
    ss = off; off += round_up(tm * (sp > hdp ? sp : hdp) * 4, 128);  // scores, then o_h (f32)
    st = off; off += NWARPS * 256 * 4;                          // per-warp 16x16 f32 staging
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

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc = A[16, K] (row-major, shared, lda) . W[n0:n0+16, 0:K]^T (W row-major [*, K], global)
__device__ __forceinline__ void tile_xwT(FragC& acc, const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* w, int K) {
  wmma::fill_fragment(acc, 0.f);
  for (int kk = 0; kk < K; kk += 16) {
    FragA fa;
    FragBc fb;
    wmma::load_matrix_sync(fa, a + kk, lda);
    wmma::load_matrix_sync(fb, w + kk, K);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

__global__ void __launch_bounds__(NTHREADS)
fused_cross_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wq,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ wo,
                   const float* __restrict__ bo,
                   __nv_bfloat16* __restrict__ out,
                   int N, int C, int H, int S, int tm, float scale_log2) {
  const int hd = C / H, hdp = round_up(hd, 16), sp = round_up(S, 16);
  const Layout L(tm, C, hdp, sp);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.qs);
  __nv_bfloat16* Qh = reinterpret_cast<__nv_bfloat16*>(smem + L.qh);
  __nv_bfloat16* Kh = reinterpret_cast<__nv_bfloat16*>(smem + L.kh);
  __nv_bfloat16* Vh = reinterpret_cast<__nv_bfloat16*>(smem + L.vh);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L.ps);
  float* Ss = reinterpret_cast<float*>(smem + L.ss);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* St = reinterpret_cast<float*>(smem + L.st) + warp * 256;

  const int b = blockIdx.y, n0 = blockIdx.x * tm;
  const __nv_bfloat16* xb = x + ((long)b * N + n0) * C;
  const int chunks = C / 8;
  for (int i = tid; i < tm * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n0 + r < N) val = *reinterpret_cast<const uint4*>(xb + (long)r * C + c);
    *reinterpret_cast<uint4*>(Xs + r * C + c) = val;
  }
  __syncthreads();

  // q = x . Wq^T, rounded to bf16 (as the TPU kernel does)
  const int ctiles = C / 16, rtiles = tm / 16;
  for (int t = warp; t < rtiles * ctiles; t += NWARPS) {
    const int rt = t / ctiles, ct = t % ctiles;
    FragC acc;
    tile_xwT(acc, Xs + rt * 16 * C, C, wq + (long)ct * 16 * C, C);
    wmma::store_matrix_sync(St, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      Qs[(rt * 16 + e / 16) * C + ct * 16 + e % 16] = __float2bfloat16(St[e]);
    __syncwarp();
  }
  __syncthreads();

  __nv_bfloat16* Os = Xs;  // x is no longer needed: it now holds concat(o_h)
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

    // scores [tm, sp] = q_h . k_h^T
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

    // exact softmax over the S keys of each row (padded keys -> 0)
    for (int r = warp; r < tm; r += NWARPS) {
      float* srow = Ss + r * sp;
      float mx = -INFINITY;
      for (int c = lane; c < S; c += 32) mx = fmaxf(mx, srow[c] * scale_log2);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int c = lane; c < S; c += 32) {
        const float p = exp2f(srow[c] * scale_log2 - mx);
        srow[c] = p;
        sum += p;
      }
      const float inv = 1.f / warp_sum(sum);
      for (int c = lane; c < sp; c += 32)
        Ps[r * sp + c] = __float2bfloat16(c < S ? srow[c] * inv : 0.f);
    }
    __syncthreads();

    // o_h [tm, hdp] = p . v_h, staged in Ss (f32), then into Os as bf16
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
      Os[r * C + h * hd + d] = __float2bfloat16(Ss[r * hdp + d]);
    }
    __syncthreads();
  }

  // out = concat(o_h) . Wo^T + bo
  __nv_bfloat16* ob = out + ((long)b * N + n0) * C;
  for (int t = warp; t < rtiles * ctiles; t += NWARPS) {
    const int rt = t / ctiles, ct = t % ctiles;
    FragC acc;
    tile_xwT(acc, Os + rt * 16 * C, C, wo + (long)ct * 16 * C, C);
    wmma::store_matrix_sync(St, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = rt * 16 + e / 16, c = ct * 16 + e % 16;
      if (n0 + r < N) ob[(long)r * C + c] = __float2bfloat16(St[e] + bo[c]);
    }
    __syncwarp();
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int fused_cross_attention_fwd(const void* x, const void* wq, const void* k,
                                         const void* v, const void* wo, const void* bo,
                                         void* out, int B, int N, int C, int H, int S,
                                         float scale, void* stream) {
  if (C % 16 != 0 || H <= 0 || C % H != 0 || S <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const int tm = C <= 640 ? 32 : 16;
  const Layout L(tm, C, round_up(C / H, 16), round_up(S, 16));
  cudaError_t err = cudaFuncSetAttribute(fused_cross_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + tm - 1) / tm, B);
  fused_cross_kernel<<<grid, NTHREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wq),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(wo), static_cast<const float*>(bo),
      static_cast<__nv_bfloat16*>(out), N, C, H, S, tm, scale * LOG2E);
  return (int)cudaGetLastError();
}
