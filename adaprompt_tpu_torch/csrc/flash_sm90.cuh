// Inline-PTX building blocks of the port's FlashAttention-2-style kernels
// for Hopper (sm_90a): 16-byte cp.async copies into shared memory, ldmatrix
// (plain and transposed) and the bf16 mma.sync.m16n8k16 with fp32 sums,
// plus the padded shared-memory row stride that keeps ldmatrix free of bank
// conflicts; and the tile steps of a flash forward on them (staging q and a
// K/V tile, Q's fragments, S = Q.K^T, the key bias and the ragged edge,
// the online-softmax step, O += P.V, the epilogue), which the two-chain, the
// no-max and the fused self-attention kernels share; and the staging of one
// head's K/V that the fused cross-attention kernels share.
// Header-only; each kernel source that includes it is built on its own
// (ops/cuda_build.py hashes this header into the library's name).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                         a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9)
//   B (16x8, "col"):      b0 (k rows 2t, 2t+1, col g), b1 (k rows 2t+8, 2t+9, col g)
//   C (16x8, fp32):       c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1)
// So the C fragments of two neighbouring n8 tiles of a score row block are,
// rounded to bf16 in pairs, the A fragment of the next product over those 16
// keys: P goes from the score registers to the tensor cores without a trip
// through shared memory.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_sm90 {

// Shared-memory row stride, in bf16 elements, for rows of `cols` (a multiple
// of 16) values: one 16-byte unit more, so that the stride is an odd number of
// 16-byte units and the 8 rows an ldmatrix reads fall in 8 distinct bank
// groups.
__host__ __device__ constexpr int padded_row(int cols) { return cols + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only. With valid == false nothing is
// read and the 16 bytes are zero-filled (the ragged edge of a tile).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

// 4 bytes global -> shared (cached in L1 too), for operands without 16-byte
// alignment; zero-filled when !valid.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The same, each matrix transposed: lane l receives rows 2(l%4), 2(l%4)+1 of
// column l/4, the B fragment of a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// Two transposed 8x8 matrices; lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// d += a . b on the tensor cores: [16x16] bf16 x [16x8] bf16 -> [16x8] fp32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed, `lo` in the low half (the lower
// column of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the MUFU unit (ex2.approx, subnormal results flushed to zero): the
// exponential of an online softmax whose argument is already in log2 units.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over the four lanes of a quad, which share a fragment row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Tile steps of a flash forward kernel on the layout above, shared by the
// two-chain and the no-max kernels. A warp owns 16*MT query rows (MT m16
// tiles) of a block whose shared-memory rows are SROW elements long; the head
// dim is D = 8*DN, padded to KS*16 for Q.K^T only; a key tile of 8*NT keys.

constexpr float kLog2e = 1.4426950408889634f;

// eight bf16 values times f, each rounded to bf16 again (q-hat as staged)
__device__ __forceinline__ uint4 bf16x8_times(uint4 v, float f) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    p[i] = __floats2bfloat162_rn(x.x * f, x.y * f);
  }
  return v;
}

// Rows [q0, q0 + ROWS) of one head's q -> Qs, 16 bytes a thread; with SCALE
// each value is multiplied by f and rounded to bf16 again. Rows past Sq are
// zero. The caller publishes Qs with a block barrier.
template <int DN, int ROWS, int SROW, int NTHREADS, bool SCALE>
__device__ __forceinline__ void stage_q(__nv_bfloat16* Qs, const __nv_bfloat16* qb, int q0,
                                        int Sq, long rs, float f, int tid) {
  for (int i = tid; i < ROWS * DN; i += NTHREADS) {
    const int r = i / DN, c = (i % DN) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (long)(q0 + r) * rs + c);
    if (SCALE) val = bf16x8_times(val, f);
    *reinterpret_cast<uint4*>(Qs + r * SROW + c) = val;
  }
}

// Keys [k0, k0 + ROWS) of one head's K and V -> Kst, Vst ([ROWS][SROW]) and,
// with a key bias, its ROWS values -> Bst, all by cp.async (the caller
// commits the group); keys past Sk are zero-filled, not read.
template <int DN, int ROWS, int SROW, int NTHREADS>
__device__ __forceinline__ void stage_kv(__nv_bfloat16* Kst, __nv_bfloat16* Vst, float* Bst,
                                         const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                         const float* biasb, int k0, int Sk, long rs, int tid) {
  for (int i = tid; i < ROWS * DN; i += NTHREADS) {
    const int r = i / DN, c = (i % DN) * 8;
    const bool ok = k0 + r < Sk;
    const long off = ok ? (long)(k0 + r) * rs + c : 0;
    cp_async_16(smem_addr(Kst + r * SROW + c), kb + off, ok);
    cp_async_16(smem_addr(Vst + r * SROW + c), vb + off, ok);
  }
  if (biasb)
    for (int i = tid; i < ROWS; i += NTHREADS) {
      const bool ok = k0 + i < Sk;
      cp_async_4(smem_addr(Bst + i), biasb + (ok ? k0 + i : 0), ok);
    }
}

// One head's K and V of a batch row for the fused cross-attention kernels
// (csrc/fused_cross_attention.cu, csrc/fused_cross_attention_int8.cu), all SKP
// keys at once: kb, vb -> Ks, Vs ([SKP][KROW]), rows C apart; keys past S and
// columns past hd are zero. With hd % 8 == 0 by cp.async (the caller
// commits), else by plain loads.
template <int SKP, int HDP, int KROW, int NTHREADS>
__device__ __forceinline__ void stage_head_kv(__nv_bfloat16* Ks, __nv_bfloat16* Vs,
                                              const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                              int S, int C, int hd, int tid) {
  if (hd % 8 == 0) {
    constexpr int UNITS = HDP / 8;
    for (int i = tid; i < SKP * UNITS; i += NTHREADS) {
      const int s = i / UNITS, c = (i % UNITS) * 8;
      const bool ok = s < S && c < hd;
      const long off = ok ? (long)s * C + c : 0;
      cp_async_16(smem_addr(Ks + s * KROW + c), kb + off, ok);
      cp_async_16(smem_addr(Vs + s * KROW + c), vb + off, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < SKP * HDP; i += NTHREADS) {
      const int s = i / HDP, d = i % HDP;
      const bool ok = s < S && d < hd;
      Ks[s * KROW + d] = ok ? kb[(long)s * C + d] : zero;
      Vs[s * KROW + d] = ok ? vb[(long)s * C + d] : zero;
    }
  }
}

// The A fragments of the warp's rows [row0, row0 + 16*MT) of Qs, by ldmatrix.
template <int MT, int KS, int SROW>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[MT][KS][4],
                                                 const __nv_bfloat16* Qs, int row0, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[mt][kk], smem_addr(Qs + (row0 + mt * 16 + lane % 8 + (lane / 8) % 2 * 8) * SROW
                                        + kk * 16 + lane / 16 * 8));
}

// S = Q.K^T over the 8*NT keys of Kst (NT even): [16*MT x 8*NT] fp32 in the
// C fragments s[mt][n8 tile].
template <int MT, int KS, int NT, int SROW>
__device__ __forceinline__ void qk_product(float (&s)[MT][NT][4], const uint32_t (&qf)[MT][KS][4],
                                           const __nv_bfloat16* Kst, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
      uint32_t kf[4];                                             // B fragments of n8 tiles 2*j2, 2*j2+1
      ldmatrix_x4(kf, smem_addr(Kst + (j2 * 16 + lane % 8 + lane / 16 * 8) * SROW
                                + kk * 16 + (lane / 8) % 2 * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(s[mt][2 * j2], qf[mt][kk], kf[0], kf[1]);
        mma_bf16_16816(s[mt][2 * j2 + 1], qf[mt][kk], kf[2], kf[3]);
      }
    }
  }
}

// s = s*f + bias*log2(e) with the tile's key bias Bst (8*NT values).
template <int MT, int NT>
__device__ __forceinline__ void add_key_bias(float (&s)[MT][NT][4], const float* Bst, float f,
                                             int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 kb2 = *reinterpret_cast<const float2*>(Bst + j * 8 + 2 * t);
    const float b0 = kb2.x * kLog2e, b1 = kb2.y * kLog2e;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      s[mt][j][0] = fmaf(s[mt][j][0], f, b0);
      s[mt][j][1] = fmaf(s[mt][j][1], f, b1);
      s[mt][j][2] = fmaf(s[mt][j][2], f, b0);
      s[mt][j][3] = fmaf(s[mt][j][3], f, b1);
    }
  }
}

// -inf for the keys at or past Sk of a tile that starts at key k0.
template <int MT, int NT>
__device__ __forceinline__ void mask_keys_past(float (&s)[MT][NT][4], int k0, int Sk, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = k0 + j * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (c >= Sk) s[mt][j][0] = s[mt][j][2] = -INFINITY;
      if (c + 1 >= Sk) s[mt][j][1] = s[mt][j][3] = -INFINITY;
    }
  }
}

// One online-softmax step on a tile's scores s (turned into p, unnormalized):
// rows g (e = 0, 1) and g+8 (e = 2, 3) of each m16 tile; the running max m
// and the per-thread partial row sum l updated, O and l rescaled by alpha.
// sc multiplies s and m in the exponent (the scale when the max is taken on
// the raw product, 1 when s is already in log2 units).
template <int MT, int NT, int DN>
__device__ __forceinline__ void online_softmax(float (&s)[MT][NT][4], float (&o)[MT][DN][4],
                                               float (&m)[MT][2], float (&l)[MT][2], float sc) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[mt][r];
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
      mx = quad_max(mx);
      const float alpha = exp2_approx((m[mt][r] - mx) * sc);     // 0 on the first tile
      m[mt][r] = mx;
      const float msc = mx * sc;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = exp2_approx(fmaf(s[mt][j][e], sc, -msc));
          s[mt][j][e] = p;
          rsum += p;
        }
      l[mt][r] = l[mt][r] * alpha + rsum;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        o[mt][dn][2 * r] *= alpha;
        o[mt][dn][2 * r + 1] *= alpha;
      }
    }
}

// O += P.V over the 8*NT keys of Vst: P from the score registers, rounded to
// bf16 in pairs, as the A fragments; V's B fragments by ldmatrix.trans, over
// D in n8 steps (an odd last step by ldmatrix.x2.trans: D=40 is not padded).
template <int MT, int NT, int DN, int SROW>
__device__ __forceinline__ void pv_product(float (&o)[MT][DN][4], const float (&p)[MT][NT][4],
                                           const __nv_bfloat16* Vst, int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      pa[mt][0] = pack_bf16(p[mt][2 * kk][0], p[mt][2 * kk][1]);
      pa[mt][1] = pack_bf16(p[mt][2 * kk][2], p[mt][2 * kk][3]);
      pa[mt][2] = pack_bf16(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
      pa[mt][3] = pack_bf16(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
    }
    const __nv_bfloat16* vrow = Vst + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * SROW;
#pragma unroll
    for (int dp = 0; dp < DN / 2; ++dp) {
      uint32_t vf[4];                                             // B fragments of n8 tiles 2*dp, 2*dp+1
      ldmatrix_x4_trans(vf, smem_addr(vrow + dp * 16 + lane / 16 * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(o[mt][2 * dp], pa[mt], vf[0], vf[1]);
        mma_bf16_16816(o[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
      }
    }
    if (DN % 2) {
      uint32_t vf[2];
      ldmatrix_x2_trans(vf, smem_addr(vrow + (DN - 1) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(o[mt][DN - 1], pa[mt], vf[0], vf[1]);
    }
  }
}

// The epilogue: O[mt] times inv[mt][r] (rows g, g+8) rounded to bf16 into the
// warp's own rows of the staging tile Qs (no other warp reads them), then
// stored 16 bytes a lane to the rows before Sq of outb ([Sq][rs], the head's
// first column); with BOUNDED, the columns before `cols` only.
template <int MT, int DN, int SROW, bool BOUNDED = false>
__device__ __forceinline__ void store_rows(__nv_bfloat16* outb, __nv_bfloat16* Qs,
                                           const float (&o)[MT][DN][4], const float (&inv)[MT][2],
                                           int row0, int q0, int Sq, long rs, int lane,
                                           int cols = 0) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + mt * 16 + g + 8 * r;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        *reinterpret_cast<uint32_t*>(Qs + row * SROW + dn * 8 + 2 * t) =
            pack_bf16(o[mt][dn][2 * r] * inv[mt][r], o[mt][dn][2 * r + 1] * inv[mt][r]);
    }
  __syncwarp();
  for (int i = lane; i < 16 * MT * DN; i += 32) {
    const int row = row0 + i / DN, c = (i % DN) * 8;
    if (q0 + row < Sq && (!BOUNDED || c < cols))
      *reinterpret_cast<uint4*>(outb + (long)(q0 + row) * rs + c) =
          *reinterpret_cast<const uint4*>(Qs + row * SROW + c);
  }
}

}  // namespace flash_sm90
