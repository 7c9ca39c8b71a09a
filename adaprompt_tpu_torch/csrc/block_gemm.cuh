// A block-GEMM main loop for Hopper (sm_90a) and its epilogue's staging
// tile, shared by the port's two-kernel feed-forward (csrc/geglu.cu) and
// cross- and self-attention (csrc/fused_cross_attention.cu,
// csrc/fused_self_attention.cu); the out-projection tile of the last two;
// and its int8 sibling BlockGemmS8, the main loop of the w8a8 feed-forward
// (csrc/geglu_int8.cu).
//
// BlockGemm computes one BM x BN tile of C = A.B^T, with A [M, K] and B [N, K]
// both K-contiguous bf16 and the sums in fp32: WM x WN warps, each holding
// 16*MT rows by 8*NT columns of the tile in mma.m16n8k16 C fragments; a
// STAGES-deep cp.async ring of A and B tiles BK deep in K, rows padded to an
// odd number of 16-byte units (padded_row) so that ldmatrix is free of bank
// conflicts. A caller names, for each row a thread copies, its source and
// whether it is in range; rows out of range and 16-byte units past K are
// zero-filled by cp.async, so ragged edges add nothing to the sums. The main
// loop ends with the ring drained and a block barrier, so the epilogue may
// reuse the ring's shared memory: Staging packs bf16 results into it and
// writes them out in 16-byte row pieces.
//
// BlockGemmS8 is the same main loop for int8 operands with exact int32 sums
// (mma.m16n8k32 s8 x s8 -> s32), counted in bytes: a 16-byte unit holds 16
// int8 values, a ring row is BK bytes padded by one unit, and one k step of
// the tensor cores is 32 deep. On K-contiguous rows the A and B fragments of
// m16n8k32 lie in 16-byte rows exactly as those of m16n8k16 do, so ldmatrix
// fetches them with the same addressing; k steps wholly past K are skipped.
//
// What it leaves for later: wgmma and TMA, and a persistent grid whose next
// tile's loads overlap this tile's epilogue. Header-only, on the helpers of
// flash_sm90.cuh; ops/cuda_build.py hashes both headers into the name of
// every library that includes them.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace block_gemm {

using namespace flash_sm90;
using bf16 = __nv_bfloat16;

// One block tile of C = A.B^T, BM x BN, and its main loop: WM x WN warps,
// a STAGES-deep cp.async ring of A and B tiles BK deep in K.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct BlockGemm {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int NTHREADS = WM * WN * 32;
  static constexpr int SROW = padded_row(BK);              // ring row stride (elements)
  static constexpr int MT = BM / WM / 16;                  // m16 tiles a warp
  static constexpr int NT = BN / WN / 8;                   // n8 tiles a warp
  static constexpr int UNITS = BK / 8;                     // 16-byte units a ring row
  static constexpr int ROWS_A_PASS = NTHREADS / UNITS;     // rows one pass of the block copies
  static constexpr int A_LOADS = BM / ROWS_A_PASS;         // 16-byte units a thread a stage
  static constexpr int B_LOADS = BN / ROWS_A_PASS;
  static constexpr int STAGE = (BM + BN) * SROW;           // elements a ring stage
  static constexpr int SMEM = STAGES * STAGE * 2;          // bytes
  static_assert(NT % 2 == 0 && A_LOADS * ROWS_A_PASS == BM && B_LOADS * ROWS_A_PASS == BN,
                "tile shape");

  // A thread copies the 16-byte unit at column (tid % UNITS) * 8 of the
  // stage's rows tid / UNITS + ROWS_A_PASS * i. src[i] points at that unit of
  // k tile 0 (anywhere valid if the row is out of range, ok[i] false).
  template <int N>
  struct Rows {
    const bf16* src[N];
    bool ok[N];
  };
  using ARows = Rows<A_LOADS>;
  using BRows = Rows<B_LOADS>;

  static __device__ __forceinline__ int row_of(int tid, int i) {
    return tid / UNITS + ROWS_A_PASS * i;
  }
  static __device__ __forceinline__ int col_of(int tid) { return (tid % UNITS) * 8; }

  static __device__ __forceinline__ void load_stage(bf16* st, const ARows& a, const BRows& b,
                                                    int k0, int K, int tid) {
    const int c = col_of(tid);
    const bool kok = k0 + c < K;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const bool ok = a.ok[i] && kok;
      cp_async_16(smem_addr(st + row_of(tid, i) * SROW + c), a.src[i] + (ok ? k0 : 0), ok);
    }
    bf16* Bs = st + BM * SROW;
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const bool ok = b.ok[i] && kok;
      cp_async_16(smem_addr(Bs + row_of(tid, i) * SROW + c), b.src[i] + (ok ? k0 : 0), ok);
    }
  }

  // acc = A . B^T over K for the warp's 16*MT rows (from row (warp / WN) * 16*MT)
  // and 8*NT B rows (from (warp % WN) * 8*NT) of the tile. Ends with the ring
  // drained and a block barrier, so the caller may reuse its shared memory.
  static __device__ __forceinline__ void mainloop(float (&acc)[MT][NT][4], bf16* smem,
                                                  const ARows& a, const BRows& b, int K,
                                                  int tid) {
    const int lane = tid % 32, warp = tid / 32;
    const int arow = (warp / WN) * MT * 16, brow = (warp % WN) * NT * 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    const int KT = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) load_stage(smem + s * STAGE, a, b, s * BK, K, tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 2>();       // k tile kt has landed (this thread's copies)
      __syncthreads();                   // ... every thread's; and stage kt-1 is read
      const int next = kt + STAGES - 1;
      if (next < KT) load_stage(smem + (next % STAGES) * STAGE, a, b, next * BK, K, tid);
      cp_async_commit();
      const bf16* As = smem + (kt % STAGES) * STAGE;
      const bf16* Bs = As + BM * SROW;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[mt], smem_addr(As + (arow + mt * 16 + lane % 16) * SROW + kk * 16
                                        + lane / 16 * 8));
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          uint32_t bf[4];                // B fragments of n8 tiles 2*j2, 2*j2+1
          ldmatrix_x4(bf, smem_addr(Bs + (brow + j2 * 16 + lane % 8 + lane / 16 * 8) * SROW
                                    + kk * 16 + (lane / 8) % 2 * 8));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[mt][2 * j2], af[mt], bf[0], bf[1]);
            mma_bf16_16816(acc[mt][2 * j2 + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

// The epilogue's staging tile: Gemm::BM x COLS bf16 in the ring's shared
// memory, rows padded as the ring's are.
template <class Gemm, int COLS>
struct Staging {
  static constexpr int ROW = padded_row(COLS);
  static_assert(Gemm::BM * ROW * 2 <= Gemm::SMEM, "the tile fits the ring");   // bytes

  // out's values (v0, v1) at (row, col), col even
  static __device__ __forceinline__ void put(bf16* Ts, int row, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(Ts + row * ROW + col) = pack_bf16(v0, v1);
  }

  // The staged tile -> rows [m0, m0 + BM) and columns [n0, n0 + COLS) of dst
  // ([rows][ld]), 16 bytes a thread; rows at or past M and columns at or past
  // N (a multiple of 8) are skipped. The caller has published Ts with a block
  // barrier.
  static __device__ __forceinline__ void store(bf16* dst, long ld, int m0, int M, int n0, int N,
                                               const bf16* Ts, int tid) {
    constexpr int UNITS = COLS / 8;
    for (int i = tid; i < Gemm::BM * UNITS; i += Gemm::NTHREADS) {
      const int r = i / UNITS, c = (i % UNITS) * 8;
      if (m0 + r < M && n0 + c < N)
        *reinterpret_cast<uint4*>(dst + (long)(m0 + r) * ld + n0 + c) =
            *reinterpret_cast<const uint4*>(Ts + r * ROW + c);
    }
  }
};

// One Out::BM x Out::BN tile of out = bf16(o . Wo^T + bo), the
// out-projection of the fused attention kernels: block (blockIdx.x,
// blockIdx.y) takes columns from blockIdx.x * BN and rows from blockIdx.y *
// BM of out [M, C]; o [M, C] and Wo [C, C] ([out, in]) bf16, bo [C] fp32.
// A device body: each kernel source wraps it in a __global__ kernel of its
// own name, since profile_step files kernels by name.
template <class Out>
__device__ __forceinline__ void bias_out_tile(const bf16* __restrict__ o,
                                              const bf16* __restrict__ wo,
                                              const float* __restrict__ bo,
                                              bf16* __restrict__ out, int M, int C) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * Out::BN, m0 = blockIdx.y * Out::BM;
  const int c = Out::col_of(tid);
  typename Out::ARows a;
#pragma unroll
  for (int i = 0; i < Out::A_LOADS; ++i) {
    const int r = m0 + Out::row_of(tid, i);
    a.ok[i] = r < M;
    a.src[i] = o + (long)(a.ok[i] ? r : 0) * C + c;
  }
  typename Out::BRows b;
#pragma unroll
  for (int i = 0; i < Out::B_LOADS; ++i) {
    const int r = n0 + Out::row_of(tid, i);
    b.ok[i] = r < C;
    b.src[i] = wo + (long)(b.ok[i] ? r : 0) * C + c;
  }
  float acc[Out::MT][Out::NT][4];
  Out::mainloop(acc, smem, a, b, C, tid);

  using T = Staging<Out, Out::BN>;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / Out::WN, wn = warp % Out::WN, q = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < Out::NT; ++nt) {
    const int col = wn * Out::NT * 8 + nt * 8 + 2 * t;
    const bool ok = n0 + col < C;        // C even: col + 1 too
    const float bb0 = ok ? bo[n0 + col] : 0.f, bb1 = ok ? bo[n0 + col + 1] : 0.f;
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

// The resources of a kernel on tile Gemm, launched with `smem` bytes of
// dynamic shared memory over `grid`: info[0..6] = registers a thread, shared
// memory a block (bytes), the tile's rows and columns, resident blocks an
// SM, blocks in the grid, local memory a thread (bytes).
template <class Gemm, class Kernel>
cudaError_t describe_kernel(Kernel kernel, int smem, dim3 grid, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, Gemm::NTHREADS, smem);
  info[0] = attr.numRegs;
  info[1] = smem;
  info[2] = Gemm::BM;
  info[3] = Gemm::BN;
  info[4] = blocks;
  info[5] = (int)(grid.x * grid.y * grid.z);
  info[6] = (int)attr.localSizeBytes;
  return err;
}

// d += a . b on the int8 tensor cores: [16x32] s8 x [32x8] s8 -> [16x8] s32.
// Fragments as m16n8k16's, each 32-bit register holding four int8 values
// along k: a0 (row g, k 4t..4t+3), a1 (row g+8), a2, a3 (k + 16); b0 (k
// 4t..4t+3, col g), b1 (k + 16); d as the fp32 C fragment.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block tile of C = A.B^T for int8 A [M, K] and B [N, K], K contiguous,
// with int32 sums: BlockGemm's ring and warp layout, BK counted in bytes (=
// int8 values).
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct BlockGemmS8 {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int NTHREADS = WM * WN * 32;
  static constexpr int SROW = BK + 16;                     // ring row stride (bytes)
  static constexpr int MT = BM / WM / 16;                  // m16 tiles a warp
  static constexpr int NT = BN / WN / 8;                   // n8 tiles a warp
  static constexpr int UNITS = BK / 16;                    // 16-byte units a ring row
  static constexpr int ROWS_A_PASS = NTHREADS / UNITS;     // rows one pass of the block copies
  static constexpr int A_LOADS = BM / ROWS_A_PASS;         // 16-byte units a thread a stage
  static constexpr int B_LOADS = BN / ROWS_A_PASS;
  static constexpr int STAGE = (BM + BN) * SROW;           // bytes a ring stage
  static constexpr int SMEM = STAGES * STAGE;              // bytes
  // BK a multiple of 32: whole k steps, and an odd number of 16-byte units a
  // padded row, so that ldmatrix is free of bank conflicts
  static_assert(BK % 32 == 0 && NT % 2 == 0 && A_LOADS * ROWS_A_PASS == BM
                && B_LOADS * ROWS_A_PASS == BN, "tile shape");

  // As BlockGemm::Rows: src[i] points at this thread's 16-byte unit of k tile 0
  template <int N>
  struct Rows {
    const int8_t* src[N];
    bool ok[N];
  };
  using ARows = Rows<A_LOADS>;
  using BRows = Rows<B_LOADS>;

  static __device__ __forceinline__ int row_of(int tid, int i) {
    return tid / UNITS + ROWS_A_PASS * i;
  }
  static __device__ __forceinline__ int col_of(int tid) { return (tid % UNITS) * 16; }

  static __device__ __forceinline__ void load_stage(int8_t* st, const ARows& a, const BRows& b,
                                                    int k0, int K, int tid) {
    const int c = col_of(tid);
    const bool kok = k0 + c < K;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const bool ok = a.ok[i] && kok;
      cp_async_16(smem_addr(st + row_of(tid, i) * SROW + c), a.src[i] + (ok ? k0 : 0), ok);
    }
    int8_t* Bs = st + BM * SROW;
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const bool ok = b.ok[i] && kok;
      cp_async_16(smem_addr(Bs + row_of(tid, i) * SROW + c), b.src[i] + (ok ? k0 : 0), ok);
    }
  }

  // acc = A . B^T over K for the warp's 16*MT rows and 8*NT B rows, as
  // BlockGemm::mainloop; ends with the ring drained and a block barrier.
  static __device__ __forceinline__ void mainloop(int (&acc)[MT][NT][4], int8_t* smem,
                                                  const ARows& a, const BRows& b, int K,
                                                  int tid) {
    const int lane = tid % 32, warp = tid / 32;
    const int arow = (warp / WN) * MT * 16, brow = (warp % WN) * NT * 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    const int KT = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) load_stage(smem + s * STAGE, a, b, s * BK, K, tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 2>();       // k tile kt has landed (this thread's copies)
      __syncthreads();                   // ... every thread's; and stage kt-1 is read
      const int next = kt + STAGES - 1;
      if (next < KT) load_stage(smem + (next % STAGES) * STAGE, a, b, next * BK, K, tid);
      cp_async_commit();
      const int8_t* As = smem + (kt % STAGES) * STAGE;
      const int8_t* Bs = As + BM * SROW;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        if (kt * BK + kk * 32 >= K) break;   // the ragged last tile: only zeros left
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[mt], smem_addr(As + (arow + mt * 16 + lane % 16) * SROW + kk * 32
                                        + lane / 16 * 16));
#pragma unroll
        for (int j2 = 0; j2 < NT / 2; ++j2) {
          uint32_t bf[4];                // B fragments of n8 tiles 2*j2, 2*j2+1
          ldmatrix_x4(bf, smem_addr(Bs + (brow + j2 * 16 + lane % 8 + lane / 16 * 8) * SROW
                                    + kk * 32 + (lane / 8) % 2 * 16));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_s8_16832(acc[mt][2 * j2], af[mt], bf[0], bf[1]);
            mma_s8_16832(acc[mt][2 * j2 + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

}  // namespace block_gemm
