// int8-QK flash attention forward for Hopper (sm_90a), forward only, no lse:
//   s   = float(int32(q_q . k_q^T)) * (q_s*scale) * k_s + key_bias
//   out = softmax(s) . v      (fp32 online softmax, p rounded to bf16 for p.v)
// with Q and K quantized per token to int8 by the wrapper (K mean-centred
// over the keys first, which softmax cannot see), V in bf16.
//
// Replaces the TPU kernel adaprompt_tpu/ops/attention.py::_fwd_kernel_i8
// (launched from flash_attention_int8). Layouts are that kernel's operands:
// q_q [B*H, Sq, D] int8; q_s [B*H, Sq] f32; k_q transposed, [B*H, D, Sk]
// int8; k_s [B*H, Sk] f32; v [B*H, Sk, D] bf16; key_bias [B, Sk] f32 or NULL;
// out [B*H, Sq, D] bf16.
//
// What bounds it: 2*D int8 operations (q.k^T) and 2*D bf16 flops (p.v) per
// score, and one exponential; at D=40 the exponentials and the shared-memory
// round trips of the scores bind first, as in the bf16 kernel, so the int8
// tensor cores cannot show their rate here. Bytes are smaller than the bf16
// kernel's (q and k at one byte a value).
// Design: the bf16 kernel's (csrc/flash_attention.cu: one block per (b*h,
// 64-row q tile), four warps of 16 rows, 64-key tiles, online softmax row by
// row, p.v in bf16 WMMA) with q.k^T on the int8 tensor cores:
// mma.sync m16n8k32 s8 x s8 -> s32, A fragments of the warp's 16 q rows held
// in registers for the whole kernel, B fragments from the key tile. The
// contraction runs over D, which at 40 or 80 is no multiple of the
// instruction's depth of 32: the staged rows are padded with zero int8 to
// 64 and 96 in shared memory only (plus 16 bytes a row against bank
// conflicts). The instruction wants each key's D values side by side while
// the operand comes transposed ([D, Sk], keys side by side), so staging a key
// tile transposes it: 4 keys of one d are read as a word and scattered as
// bytes. The dequantization multiplies by the row scale, then by the column
// scale, each rounded on its own (no FMA), as the plain version's tensor
// operations round.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 16;         // bytes added to each int8 row
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

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

// c[16x8] += A[16x32] . B[32x8], int8 operands, int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// depth of the int8 contraction: D padded to a multiple of 32
template <int DP>
__host__ __device__ constexpr int depth() { return (DP + 31) / 32 * 32; }

template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + BK) * (depth<DP>() + PAD) +
         (size_t)(BK * DP + BQ * BK) * sizeof(bf16) +
         (size_t)(BQ * BK + BQ * DP + 4 * BQ + BK) * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_int8_kernel(const int8_t* __restrict__ qq, const float* __restrict__ qs,
                      const int8_t* __restrict__ kt, const float* __restrict__ ks,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      bf16* __restrict__ out, int H, int Sq, int Sk, int D, float scale) {
  constexpr int DK = depth<DP>();
  constexpr int KP = DK + PAD;                                    // int8 row stride, bytes
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Qq = reinterpret_cast<int8_t*>(smem);                   // [BQ][KP]
  int8_t* Kq = Qq + BQ * KP;                                      // [BK][KP]
  bf16* Vs = reinterpret_cast<bf16*>(Kq + BK * KP);               // [BK][DP]
  bf16* Ps = Vs + BK * DP;                                        // [BQ][BK]
  float* Ss = reinterpret_cast<float*>(Ps + BQ * BK);             // [BQ][BK]
  float* Os = Ss + BQ * BK;                                       // [BQ][DP]
  float* m_s = Os + BQ * DP;                                      // [BQ] running max (log2 domain)
  float* l_s = m_s + BQ;                                          // [BQ] running sum
  float* a_s = l_s + BQ;                                          // [BQ] rescale factor
  float* qs_s = a_s + BQ;                                         // [BQ] q_s * scale
  float* ks_s = qs_s + BQ;                                        // [BK] k_s of this tile

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int8_t* qb = qq + (long)bh * Sq * D;
  const int8_t* ktb = kt + (long)bh * D * Sk;
  const bf16* vb = v + (long)bh * Sk * D;
  const float* biasb = bias ? bias + (long)b * Sk : nullptr;
  const bool vec4 = Sk % 4 == 0;                                  // 4 keys of one d: an aligned word

  // zero the int8 tiles and V once: their pad columns then stay zero
  for (int i = tid; i < (BQ + BK) * KP / 4; i += NTHREADS) reinterpret_cast<uint32_t*>(Qq)[i] = 0u;
  for (int i = tid; i < BK * DP; i += NTHREADS) Vs[i] = __float2bfloat16(0.f);
  for (int i = tid; i < BQ * DP; i += NTHREADS) Os[i] = 0.f;
  for (int i = tid; i < BQ; i += NTHREADS) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
    qs_s[i] = q0 + i < Sq ? __fmul_rn(qs[(long)bh * Sq + q0 + i], scale) : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < BQ * (D / 8); i += NTHREADS) {            // q tile, 8 bytes a load
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint2 val = make_uint2(0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint2*>(qb + (long)(q0 + r) * D + c);
    *reinterpret_cast<uint2*>(Qq + r * KP + c) = val;
  }
  __syncthreads();

  const int row0 = warp * 16;                                     // this warp's query rows
  const int g = lane >> 2, t4 = (lane & 3) * 4;                   // fragment row, byte column
  uint32_t afrag[DK / 32][4];                                     // the warp's q rows, kept throughout
#pragma unroll
  for (int kk = 0; kk < DK / 32; ++kk) {
    const int8_t* ar = Qq + (row0 + g) * KP + kk * 32 + t4;
    afrag[kk][0] = *reinterpret_cast<const uint32_t*>(ar);
    afrag[kk][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * KP);
    afrag[kk][2] = *reinterpret_cast<const uint32_t*>(ar + 16);
    afrag[kk][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * KP + 16);
  }

  const int vchunks = D / 8;                                      // 16-byte chunks per V row
  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();                                              // previous tile fully consumed
    for (int i = tid; i < D * (BK / 4); i += NTHREADS) {          // K tile, transposed while staged
      const int d = i / (BK / 4), kk = (i % (BK / 4)) * 4;
      const int8_t* src = ktb + (long)d * Sk + k0 + kk;
      uint32_t w = 0u;
      if (vec4 && k0 + kk + 3 < Sk) {
        w = *reinterpret_cast<const uint32_t*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + kk + j < Sk) w |= (uint32_t)(uint8_t)src[j] << (8 * j);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) Kq[(kk + j) * KP + d] = (int8_t)(w >> (8 * j));
    }
    for (int i = tid; i < BK * vchunks; i += NTHREADS) {
      const int r = i / vchunks, c = (i % vchunks) * 8;
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk) vv = *reinterpret_cast<const uint4*>(vb + (long)(k0 + r) * D + c);
      *reinterpret_cast<uint4*>(Vs + r * DP + c) = vv;
    }
    for (int i = tid; i < BK; i += NTHREADS)
      ks_s[i] = k0 + i < Sk ? ks[(long)bh * Sk + k0 + i] : 0.f;
    __syncthreads();

    // scores S[row0:row0+16, 0:BK] on the int8 tensor cores, dequantized
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* br = Kq + (j * 8 + g) * KP + t4;
#pragma unroll
      for (int kk = 0; kk < DK / 32; ++kk)
        mma_s8(acc, afrag[kk], *reinterpret_cast<const uint32_t*>(br + kk * 32),
               *reinterpret_cast<const uint32_t*>(br + kk * 32 + 16));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + g + (i >> 1) * 8, c = j * 8 + (lane & 3) * 2 + (i & 1);
        Ss[r * BK + c] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), qs_s[r]), ks_s[c]);
      }
    }
    __syncwarp();

    // online softmax over this tile, one row at a time, two keys per lane
    const int c0 = lane, c1 = lane + 32;
    const bool ok0 = k0 + c0 < Sk, ok1 = k0 + c1 < Sk;
    const float bias0 = (biasb && ok0) ? biasb[k0 + c0] : 0.f;
    const float bias1 = (biasb && ok1) ? biasb[k0 + c1] : 0.f;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const float s0 = ok0 ? (Ss[r * BK + c0] + bias0) * LOG2E : -INFINITY;
      const float s1 = ok1 ? (Ss[r * BK + c1] + bias1) * LOG2E : -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      Ps[r * BK + c0] = __float2bfloat16(p0);
      Ps[r * BK + c1] = __float2bfloat16(p1);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = row0 + i / DP;
      Os[r * DP + i % DP] *= a_s[r];
    }
    __syncwarp();

    // O[row0:row0+16, :] += P V in bf16
#pragma unroll
    for (int dj = 0; dj < DP / 16; ++dj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo;
      wmma::load_matrix_sync(fo, Os + row0 * DP + dj * 16, DP, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fp, Ps + row0 * BK + kk, BK);
        wmma::load_matrix_sync(fv, Vs + kk * DP + dj * 16, DP);
        wmma::mma_sync(fo, fp, fv, fo);
      }
      wmma::store_matrix_sync(Os + row0 * DP + dj * 16, fo, DP, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = row0 + i / D, d = i % D;
    if (q0 + r < Sq)
      out[((long)bh * Sq + q0 + r) * D + d] = __float2bfloat16(Os[r * DP + d] / l_s[r]);
  }
}

template <int DP>
cudaError_t launch(const void* qq, const void* qs, const void* kt, const void* ks,
                   const void* v, const void* bias, void* out, int B, int Sq, int Sk, int H,
                   int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_int8_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_int8_kernel<DP><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const int8_t*>(qq), static_cast<const float*>(qs),
      static_cast<const int8_t*>(kt), static_cast<const float*>(ks),
      static_cast<const bf16*>(v), static_cast<const float*>(bias), static_cast<bf16*>(out),
      H, Sq, Sk, D, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int flash_attention_int8_fwd(const void* qq, const void* qs, const void* kt,
                                        const void* ks, const void* v, const void* bias,
                                        void* out, int B, int Sq, int Sk, int H, int D,
                                        float scale, void* stream) {
  if (D % 8 != 0 || D <= 0 || D > 128 || Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_I8_CASE(DP) \
  case DP: return (int)launch<DP>(qq, qs, kt, ks, v, bias, out, B, Sq, Sk, H, D, scale, s);
  switch ((D + 15) / 16 * 16) {
    FLASH_I8_CASE(16)
    FLASH_I8_CASE(32)
    FLASH_I8_CASE(48)
    FLASH_I8_CASE(64)
    FLASH_I8_CASE(80)
    FLASH_I8_CASE(96)
    FLASH_I8_CASE(112)
    FLASH_I8_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_I8_CASE
}
