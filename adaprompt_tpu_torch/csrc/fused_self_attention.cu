// Fused self-attention for Hopper (sm_90a), forward only: for a tile of rows
// of x,
//   q = x . Wq^T;  per head h: o_h = softmax(q_h . k_h^T * scale + key_bias) . v_h
//   out = concat_h(o_h) . Wo^T + bo
// over all N keys of a packed K|V tensor, with q and the concatenated o kept
// in shared memory: of the [B, N, C] activations only x, K|V and out touch
// device memory.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fused_self_kernel
// (launched from fused_self_attention). Layouts: x [B, N, C] bf16; Wq, Wo
// [C, C] bf16 in PyTorch's [out, in] layout; kv [B, N, 2C] bf16, K in columns
// [0, C) and V in [C, 2C), head h in columns h*hd of each half (the wrapper's
// one x.[Wk|Wv] product, left to torch.matmul as the JAX package leaves it
// to XLA); bo [C] f32; key_bias [B, N] f32 or NULL; out [B, N, C] bf16.
//
// What bounds it: the attention, 4*N*N*C flops per batch row and one
// exponential per score and head, plus the two C x C projections (4*N*C*C);
// bytes are x, kv and out once. As in the flash kernel the exponentials and
// the scores' shared-memory round trips bind at hd=40, not the tensor cores.
// Design: the TPU kernel keeps a batch row's whole [N, 2C] K|V on chip
// (5.2 MB at N=4096, C=320); an SM has 227 KB, so this kernel streams K|V in
// 64-key tiles per head with an online softmax (running max and sum per row,
// accumulator rescaled per tile, one division at the end where the TPU
// kernel normalizes p before p.v: the same function up to rounding). It is
// the fused cross-attention kernel (csrc/fused_cross_attention.cu: q tile and
// head concat in shared memory, weights read by WMMA from L2) with that
// loop in place of its one-shot softmax over 77 keys. A block takes 32 rows
// of x (16 above C=640) so that two blocks fit an SM at C=320; its four warps
// share each phase's 16x16 tiles and meet at block barriers. hd=40 is padded
// to 48 in shared memory only; ragged N is masked (keys past N score -inf,
// rows past N are not written).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BK = 64;          // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_SMEM = 232448;   // a block's shared memory on sm_90
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Layout {          // shared-memory carve-up, byte offsets (128-aligned)
  int xs, qs, qh, kh, vh, ps, ss, oa, ml, st, total;
  __host__ __device__ Layout(int tm, int C, int hdp) {
    int off = 0;
    xs = off; off += round_up(tm * C * 2, 128);                 // x tile, later concat(o_h)
    qs = off; off += round_up(tm * C * 2, 128);                 // q tile
    qh = off; off += round_up(tm * hdp * 2, 128);               // q of one head, padded
    kh = off; off += round_up(BK * hdp * 2, 128);               // a key tile of one head, padded
    vh = off; off += round_up(BK * hdp * 2, 128);               // its values
    ps = off; off += round_up(tm * BK * 2, 128);                // probabilities (bf16)
    ss = off; off += round_up(tm * BK * 4, 128);                // scores (f32)
    oa = off; off += round_up(tm * hdp * 4, 128);               // o_h accumulator (f32)
    ml = off; off += round_up(2 * tm * 4, 128);                 // running max and sum per row
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

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc = A[16, K] (row-major, shared, lda) . W[n0:n0+16, 0:K]^T (W row-major [*, K], global)
__device__ __forceinline__ void tile_xwT(FragC& acc, const bf16* a, int lda, const bf16* w, int K) {
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
fused_self_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                  const bf16* __restrict__ kv, const bf16* __restrict__ wo,
                  const float* __restrict__ bo, const float* __restrict__ bias,
                  bf16* __restrict__ out, int N, int C, int H, int tm, float scale_log2) {
  const int hd = C / H, hdp = round_up(hd, 16);
  const Layout L(tm, C, hdp);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.qs);
  bf16* Qh = reinterpret_cast<bf16*>(smem + L.qh);
  bf16* Kh = reinterpret_cast<bf16*>(smem + L.kh);
  bf16* Vh = reinterpret_cast<bf16*>(smem + L.vh);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.ps);
  float* Ss = reinterpret_cast<float*>(smem + L.ss);
  float* Oa = reinterpret_cast<float*>(smem + L.oa);
  float* m_s = reinterpret_cast<float*>(smem + L.ml);
  float* l_s = m_s + tm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* St = reinterpret_cast<float*>(smem + L.st) + warp * 256;

  const int b = blockIdx.y, n0 = blockIdx.x * tm;
  const bf16* xb = x + ((long)b * N + n0) * C;
  const int chunks = C / 8;
  for (int i = tid; i < tm * chunks; i += NTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n0 + r < N) val = *reinterpret_cast<const uint4*>(xb + (long)r * C + c);
    *reinterpret_cast<uint4*>(Xs + r * C + c) = val;
  }
  // zero the key and value tiles once: their pad columns [hd, hdp) then stay zero
  for (int i = tid; i < BK * hdp; i += NTHREADS) {
    Kh[i] = __float2bfloat16(0.f);
    Vh[i] = __float2bfloat16(0.f);
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

  bf16* Os = Xs;  // x is no longer needed: it now holds concat(o_h)
  const bf16* kvb = kv + (long)b * N * 2 * C;         // [N, 2C] of this batch row
  const float* biasb = bias ? bias + (long)b * N : nullptr;
  const int hchunks = hd / 8;                         // 16-byte chunks of one head's row
  const int dtiles = hdp / 16;
  for (int h = 0; h < H; ++h) {
    for (int i = tid; i < tm * hdp; i += NTHREADS) {
      const int r = i / hdp, d = i % hdp;
      Qh[i] = d < hd ? Qs[r * C + h * hd + d] : __float2bfloat16(0.f);
      Oa[i] = 0.f;
    }
    for (int i = tid; i < tm; i += NTHREADS) { m_s[i] = -INFINITY; l_s[i] = 0.f; }

    for (int k0 = 0; k0 < N; k0 += BK) {
      __syncthreads();                                // previous tile consumed; q_h, state staged
      for (int i = tid; i < BK * hchunks; i += NTHREADS) {
        const int r = i / hchunks, c = (i % hchunks) * 8;
        uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (k0 + r < N) {
          const bf16* row = kvb + (long)(k0 + r) * 2 * C + h * hd + c;
          kk = *reinterpret_cast<const uint4*>(row);
          vv = *reinterpret_cast<const uint4*>(row + C);
        }
        *reinterpret_cast<uint4*>(Kh + r * hdp + c) = kk;
        *reinterpret_cast<uint4*>(Vh + r * hdp + c) = vv;
      }
      __syncthreads();

      // scores [tm, BK] = q_h . k_h^T
      for (int t = warp; t < rtiles * (BK / 16); t += NWARPS) {
        const int rt = t / (BK / 16), ct = t % (BK / 16);
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < hdp; kk += 16) {
          FragA fa;
          FragBc fb;
          wmma::load_matrix_sync(fa, Qh + rt * 16 * hdp + kk, hdp);
          wmma::load_matrix_sync(fb, Kh + ct * 16 * hdp + kk, hdp);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Ss + rt * 16 * BK + ct * 16, acc, BK, wmma::mem_row_major);
      }
      __syncthreads();

      // online softmax: a warp takes a row at a time, two keys per lane
      const int c0 = lane, c1 = lane + 32;
      const bool ok0 = k0 + c0 < N, ok1 = k0 + c1 < N;
      const float bias0 = (biasb && ok0) ? biasb[k0 + c0] * LOG2E : 0.f;
      const float bias1 = (biasb && ok1) ? biasb[k0 + c1] * LOG2E : 0.f;
      for (int r = warp; r < tm; r += NWARPS) {
        const float s0 = ok0 ? Ss[r * BK + c0] * scale_log2 + bias0 : -INFINITY;
        const float s1 = ok1 ? Ss[r * BK + c1] * scale_log2 + bias1 : -INFINITY;
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
        const float sum = warp_sum(p0 + p1);
        const float alpha = exp2f(m_old - m_new);     // 0 on the first tile (m_old = -inf)
        Ps[r * BK + c0] = __float2bfloat16(p0);
        Ps[r * BK + c1] = __float2bfloat16(p1);
        for (int c = lane; c < hdp; c += 32) Oa[r * hdp + c] *= alpha;
        __syncwarp();                                 // every lane has read m_s[r]
        if (lane == 0) {
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // o_h [tm, hdp] += p . v_h
      for (int t = warp; t < rtiles * dtiles; t += NWARPS) {
        const int rt = t / dtiles, ct = t % dtiles;
        FragC acc;
        wmma::load_matrix_sync(acc, Oa + rt * 16 * hdp + ct * 16, hdp, wmma::mem_row_major);
        for (int kk = 0; kk < BK; kk += 16) {
          FragA fa;
          FragBr fb;
          wmma::load_matrix_sync(fa, Ps + rt * 16 * BK + kk, BK);
          wmma::load_matrix_sync(fb, Vh + kk * hdp + ct * 16, hdp);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Oa + rt * 16 * hdp + ct * 16, acc, hdp, wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int i = tid; i < tm * hd; i += NTHREADS) {
      const int r = i / hd, d = i % hd;
      Os[r * C + h * hd + d] = __float2bfloat16(Oa[r * hdp + d] / l_s[r]);
    }
    __syncthreads();
  }

  // out = concat(o_h) . Wo^T + bo
  bf16* ob = out + ((long)b * N + n0) * C;
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
extern "C" int fused_self_attention_fwd(const void* x, const void* wq, const void* kv,
                                        const void* wo, const void* bo, const void* bias,
                                        void* out, int B, int N, int C, int H, float scale,
                                        void* stream) {
  if (C % 16 != 0 || H <= 0 || C % H != 0 || (C / H) % 8 != 0 || N <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const int tm = C <= 640 ? 32 : 16;
  const Layout L(tm, C, round_up(C / H, 16));
  if (L.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_self_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + tm - 1) / tm, B);
  fused_self_kernel<<<grid, NTHREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq), static_cast<const bf16*>(kv),
      static_cast<const bf16*>(wo), static_cast<const float*>(bo),
      static_cast<const float*>(bias), static_cast<bf16*>(out), N, C, H, tm, scale * LOG2E);
  return (int)cudaGetLastError();
}
