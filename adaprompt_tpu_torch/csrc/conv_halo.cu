// 3x3 stride-1 SAME convolutions over NHWC activations for Hopper (sm_90a),
// as implicit matrix products on the tensor cores. Three C calls:
//   * conv3x3_im2col_fwd (B9; replaces adaprompt_tpu/ops/conv_halo.py::
//     conv3x3_im2col): the gathered form. Each k tile's A operand, BM output
//     pixels x BK channels of one tap, is gathered by cp.async straight from
//     x into a ring in shared memory, each row its pixel's shifted input
//     pixel; the patch matrix exists only one k tile at a time, in the ring.
//   * conv3x3_halo_fwd (B8; replaces conv_halo.py::conv3x3_halo): the halo
//     form. Per channel chunk, the (8+2) x (16+2) x BK halo of an 8 x 16
//     output tile is staged once by cp.async (double-buffered: the next
//     chunk's halo is in flight while this one's nine taps run), and the
//     nine taps are nine shifted ldmatrix windows of that one tile.
//   * gn_silu_conv3x3_halo_fwd (B7; replaces conv_halo.py::
//     gn_silu_conv3x3_halo): conv3x3(SiLU(GroupNorm(x))) + bias, on B8's
//     loop, with the GroupNorm's statistics taken by a kernel of the same call.
//
// Layouts: x [B, H, W, C] bf16; w [9, C, O] bf16, taps outermost (tap =
// 3*dy + dx), which read as [9C, O] is the im2col weight, row k = tap*C + c;
// bias [O] f32; out [B, H, W, O] bf16; B7's gs, gb [C] f32 and its affine
// [B, 2, C] f32 (a then b) in its workspace. Products accumulate in f32, the
// bias is added in f32, the result is rounded to bf16 once.
//
// What bounds them: 18*B*H*W*C*O flops against 2*B*H*W*(C+O) + 18*C*O bytes:
// at the SD-1.5 shapes hundreds of flops a byte, so the tensor cores bound
// them.
//
// B8 and B9: an implicit GEMM with M = B*H*W output pixels, N = O and
// K = 9*C in k tiles of BK = 32 channels, each inside one tap (a tap's last
// chunk zero-filled past C). A block computes a 128 x 160 tile with 8 warps
// (4 x 2), each 32 pixels x 80 channels in mma.m16n8k16 fp32 C fragments,
// two blocks an SM; A's fragments by ldmatrix from pixel rows padded to an
// odd number of 16-byte units (padded_row), B's by ldmatrix.trans from the
// weight read in place: the [BK, BN] tile of rows tap*C + c of the packed
// weight, N contiguous, streamed through a 4-deep cp.async ring. Off-image
// pixels, channels past C and columns past O are zero-filled by the copies
// (SAME padding without a padded copy of x). The halo form's tile is 8 x 16
// pixels (its halo 10 x 18: x read ~1.4 times a chunk from L2, the gathered
// form's 9). Where the tiles alone would leave SMs idle, the channel chunks
// are split into up to 4 parts over blockIdx.z (the wrapper's plan,
// ops/conv_halo.py conv_plan, picks: 2 at SD-1.5's (32, 640, 640), 4 at
// (16, 1280, 1280), B=4); each part's fp32 sums go to a workspace and a sum
// kernel adds them in a fixed order (no atomics). The epilogue adds the bias
// to the fp32 sums, rounds once to bf16 (with one part through the drained
// ring, 16-byte row pieces). C and O must be multiples of 8 (the wrapper
// pads other widths with zeros). Left for later: wgmma with TMA, a
// persistent grid whose next tile's loads overlap this tile's epilogue.
//
// B7, the fused producer: seg = float(x)*a + b, seg*sigmoid(seg) in f32,
// ROUNDED TO bf16, and exactly 0 outside the image (SAME padding pads the
// activated tensor; padding x itself would put silu(b) != 0 on the border),
// with a = rsqrt(var + eps)*gs and b = gb - (mean*rsqrt(var + eps))*gs per
// (batch, channel), the JAX function's order. Three kernels in one call:
//   * gn_silu_conv3x3_stats_kernel: one block per (batch, group) takes the
//     group's f32 sum, the mean, then the sum of squared deviations about
//     that mean in a second pass over x (which L2 serves), and writes the
//     group's a and b. Each thread sums its pieces in order, the block adds
//     the threads' sums in a fixed tree: two calls give equal bits. Bound by
//     bytes: x read once, ~3 us at the SD-1.5 shapes. A group is 10 to 30
//     channels there, 20 to 60 bytes of each pixel: the block reads them as
//     the widest aligned pieces (2 to 16 bytes), a thread always the same
//     piece of its pixels. Slabs of pixels over several blocks would read
//     16-byte units but need a combine across blocks between the two passes;
//     128 blocks of (batch, group) already fill the card at B=4.
//   * gn_silu_conv3x3_mma_kernel: B8's loop (halo_conv<true>), where each
//     chunk's landed halo gets one pass in shared memory before its first tap
//     reads it: for each in-image pixel and each channel below C, the affine,
//     SiLU (__expf and __fdividef, ~1e-7 relative: the result is rounded to
//     bf16 next; IEEE expf and division, or a round-to-nearest reciprocal,
//     cost 4-8 % of the call) and the bf16 rounding, in place. Off-image
//     pixels and channels past C keep the copies' zeros. A thread takes the
//     same 8 channels of every pixel it transforms (at most 3 a chunk) and
//     reads their a and b from L1 at each: held across its pixels they
//     pushed the accumulators into local memory (128 B of spills, 5-9 %
//     slower). The pass over chunk j + 1's halo runs during chunk j's tap
//     PASS_TAP, once that halo has landed, so it needs no barrier of its own
//     (the step's barrier orders it before the taps that read it); at the
//     chunk's own tap 0, behind one more barrier, it runs as fast (within
//     1 %, tools/gn_conv_tiles.py). The producer runs once per staged
//     element, O/160 times per pixel of x.
//   * gn_silu_conv3x3_sum_kernel: the k splits' fixed-order sum, as B8's.
// Left for later: wgmma with TMA and a persistent grid, as for B8, and the
// statistics kernel's launch overlapping the conv's prologue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// The product loop of B7, B8 and B9 on mma.sync

using flash_sm90::cp_async_16;
using flash_sm90::cp_async_commit;
using flash_sm90::cp_async_wait;
using flash_sm90::ldmatrix_x4;
using flash_sm90::ldmatrix_x4_trans;
using flash_sm90::mma_bf16_16816;
using flash_sm90::pack_bf16;
using flash_sm90::padded_row;
using flash_sm90::smem_addr;

constexpr int BK = 32;                  // input channels a k tile (inside one tap)
constexpr int KROW = padded_row(BK);    // stride of an A row / a halo pixel (elements)
constexpr int STAGES = 4;               // k tiles in flight (B9's A and both forms' weight)
constexpr int MIN_BLOCKS = 2;           // resident blocks an SM (launch bounds)
constexpr int MAX_SPLITS = 4;           // k splits (the wrapper's plan picks)
// B7: the tap of chunk j during which chunk j + 1's halo is transformed (its
// copies land by tap STAGES - 1)
constexpr int PASS_TAP = 8;
static_assert(PASS_TAP >= STAGES - 1 && PASS_TAP < 9, "PASS_TAP");

// A block's tile: BM output pixels x BN output channels on WM x WN warps,
// each 16*MT pixels x 8*NT channels.
template <int BM_, int BN_, int WM_, int WN_>
struct ConvTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int NTHREADS = WM * WN * 32;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int BROW = padded_row(BN);     // weight-tile row stride (elements)
  static constexpr int W_ELEMS = BK * BROW;       // one weight stage
  static_assert(MT * WM * 16 == BM && NT * WN * 8 == BN && NT % 2 == 0, "tile shape");
};
using MmaTile = ConvTile<128, 160, 4, 2>;

// The halo form's output tile: HTH x HTW pixels, its halo HALO_PX pixels.
constexpr int HTW = 16, HTH = MmaTile::BM / HTW, HXW = HTW + 2, HALO_PX = (HTH + 2) * HXW;
constexpr int IM2COL_STAGE = MmaTile::BM * KROW + MmaTile::W_ELEMS;   // elements
constexpr int IM2COL_SMEM = STAGES * IM2COL_STAGE * 2;                // bytes
constexpr int HALO_SMEM = (2 * HALO_PX * KROW + STAGES * MmaTile::W_ELEMS) * 2;

// The [BK, BN] weight tile of tap `tap`, channels [c0, c0 + BK), columns
// [n0, n0 + BN) -> Ws ([BK][BROW]) by cp.async; rows past C and columns past
// O zero-filled. The caller commits.
template <class T>
__device__ __forceinline__ void load_w(bf16* Ws, const bf16* __restrict__ w, int tap, int c0,
                                       int n0, int C, int O, int tid) {
  constexpr int UNITS = T::BN / 8;
  for (int i = tid; i < BK * UNITS; i += T::NTHREADS) {
    const int r = i / UNITS, u = (i % UNITS) * 8;
    const bool ok = c0 + r < C && n0 + u < O;
    const bf16* src = ok ? w + ((long)tap * C + c0 + r) * O + n0 + u : w;
    cp_async_16(smem_addr(Ws + r * T::BROW + u), src, ok);
  }
}

// acc += A . B over one k tile. a[mt]: this lane's ldmatrix row address of
// the warp's m16 tile mt at k 0 (row lane % 16, k (lane / 16) * 8); b: this
// lane's ldmatrix.trans row address of the weight tile (k row lane % 8 +
// ((lane / 8) % 2) * 8, column the warp's first + (lane / 16) * 8), so that
// one x4.trans load gives the B fragments of two neighbouring n8 tiles.
template <class T>
__device__ __forceinline__ void tile_product(float (&acc)[T::MT][T::NT][4],
                                             const uint32_t (&a)[T::MT], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t af[T::MT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) ldmatrix_x4(af[mt], a[mt] + kk * 32);
#pragma unroll
    for (int j2 = 0; j2 < T::NT / 2; ++j2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kk * 16 * T::BROW + j2 * 16) * 2);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        mma_bf16_16816(acc[mt][2 * j2], af[mt], bf[0], bf[1]);
        mma_bf16_16816(acc[mt][2 * j2 + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

template <class T>
__device__ __forceinline__ uint32_t weight_lane_addr(const bf16* Ws, int lane, int warp) {
  return smem_addr(Ws + (lane % 8 + (lane / 8) % 2 * 8) * T::BROW + (warp % T::WN) * T::NT * 8
                   + lane / 16 * 8);
}

template <class T>
__device__ __forceinline__ void zero(float (&acc)[T::MT][T::NT][4]) {
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// The channel chunks of split `split` of `splits`: [c_lo, c_lo + nc).
struct Chunks {
  int c_lo, nc;
  __device__ __forceinline__ Chunks(int C, int split, int splits) {
    const int ct = (C + BK - 1) / BK;
    c_lo = split * ct / splits;
    nc = (split + 1) * ct / splits - c_lo;
  }
};

// The epilogue. With one split: acc + bias, rounded once to bf16, into the
// [BM][BROW] staging tile Ts (the drained ring), then 16-byte row pieces to
// out. With several: split `split`'s fp32 sums, no bias, to its [M][O] slice
// of `part`, for the sum kernel. Tile row r is output pixel pixel(r) (< 0:
// not stored); columns at or past O (a multiple of 8) are skipped.
template <class T, class Pixels>
__device__ __forceinline__ void store_tile(const float (&acc)[T::MT][T::NT][4], bf16* Ts,
                                           const float* __restrict__ bias, bf16* __restrict__ out,
                                           float* __restrict__ part, int split, int splits,
                                           long M, int n0, int O, const Pixels& pixel, int tid) {
  const int lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int row0 = (warp / T::WN) * T::MT * 16, col0 = (warp % T::WN) * T::NT * 8;
  if (splits > 1) {
    float* dst = part + split * M * O + n0;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long p = pixel(row0 + mt * 16 + g + 8 * h);
        if (p < 0) continue;
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int col = col0 + nt * 8 + 2 * t;
          if (n0 + col < O)
            *reinterpret_cast<float2*>(dst + p * O + col) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    const int col = col0 + nt * 8 + 2 * t;
    const bool ok = n0 + col < O;                 // O even: col + 1 too
    const float b0 = ok ? bias[n0 + col] : 0.f, b1 = ok ? bias[n0 + col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(Ts + (row0 + mt * 16 + g + 8 * h) * T::BROW + col) =
            pack_bf16(acc[mt][nt][2 * h] + b0, acc[mt][nt][2 * h + 1] + b1);
  }
  __syncthreads();
  constexpr int UNITS = T::BN / 8;
  for (int i = tid; i < T::BM * UNITS; i += T::NTHREADS) {
    const int r = i / UNITS, c = (i % UNITS) * 8;
    const long p = pixel(r);
    if (p >= 0 && n0 + c < O)
      *reinterpret_cast<uint4*>(out + p * O + n0 + c) =
          *reinterpret_cast<const uint4*>(Ts + r * T::BROW + c);
  }
}

// B9's tile row r: output pixel m0 + r.
struct PixelRows {
  int m0, M;
  __device__ __forceinline__ long operator()(int r) const { return m0 + r < M ? m0 + r : -1; }
};

// B8's and B7's tile row r: output pixel (y0 + r / HTW, x0 + r % HTW) of image b.
struct HaloRows {
  int b, y0, x0, H, W;
  __device__ __forceinline__ long operator()(int r) const {
    const int y = y0 + r / HTW, x = x0 + r % HTW;
    return y < H && x < W ? ((long)b * H + y) * W + x : -1;
  }
};

// grid (ceil(O / BN), ceil(M / BM), splits): out[m0:m0+BM, n0:n0+BN] over
// split blockIdx.z's channel chunks; k tiles in the order (tap, chunk).
__global__ void __launch_bounds__(MmaTile::NTHREADS, MIN_BLOCKS)
conv3x3_im2col_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          const float* __restrict__ bias, bf16* __restrict__ out,
                          float* __restrict__ part, int B, int H, int W, int C, int O) {
  using T = MmaTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int UNITS = BK / 8;                      // 16-byte units an A row
  constexpr int ROWS_PASS = T::NTHREADS / UNITS;     // A rows one pass of the block copies
  constexpr int A_LOADS = T::BM / ROWS_PASS;
  static_assert(A_LOADS * ROWS_PASS == T::BM, "A rows");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  const int M = B * H * W;
  const Chunks ch(C, blockIdx.z, gridDim.z);

  // The A rows this thread copies: output pixel p at (py, px) of its image,
  // computed once; py = -2 past M puts every tap off the image.
  const int ac = (tid % UNITS) * 8;
  int py[A_LOADS], px[A_LOADS], pp[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int p = m0 + tid / UNITS + ROWS_PASS * i;
    const int rem = p % (H * W);
    pp[i] = p;
    py[i] = p < M ? rem / W : -2;
    px[i] = rem % W;
  }
  const int KT = 9 * ch.nc;
  auto load_stage = [&](int kt) {
    bf16* As = smem + (kt % STAGES) * IM2COL_STAGE;
    const int tap = kt / ch.nc, c0 = (ch.c_lo + kt - tap * ch.nc) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool cok = c0 + ac < C;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int iy = py[i] + dy, ix = px[i] + dx;
      const bool ok = cok && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const bf16* src = ok ? x + (long)(pp[i] + dy * W + dx) * C + c0 + ac : x;
      cp_async_16(smem_addr(As + (tid / UNITS + ROWS_PASS * i) * KROW + ac), src, ok);
    }
    load_w<T>(As + T::BM * KROW, w, tap, c0, n0, C, O, tid);
  };

  uint32_t a_lane[T::MT];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
    a_lane[mt] = smem_addr(smem + ((warp / T::WN) * T::MT * 16 + mt * 16 + lane % 16) * KROW
                           + lane / 16 * 8);
  const uint32_t b_lane = weight_lane_addr<T>(smem + T::BM * KROW, lane, warp);
  float acc[T::MT][T::NT][4];
  zero<T>(acc);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();       // k tile kt has landed (this thread's copies)
    __syncthreads();                   // ... every thread's; and stage kt-1 is read
    if (kt + STAGES - 1 < KT) load_stage(kt + STAGES - 1);
    cp_async_commit();
    const uint32_t st = (kt % STAGES) * IM2COL_STAGE * 2;
    uint32_t a[T::MT];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) a[mt] = a_lane[mt] + st;
    tile_product<T>(acc, a, b_lane + st);
  }
  cp_async_wait<0>();
  __syncthreads();
  store_tile<T>(acc, smem, bias, out, part, blockIdx.z, gridDim.z, M, n0, O,
                PixelRows{m0, M}, tid);
}

// B7's producer over the landed halo Xb of channels [c0, c0 + BK) of image
// tile (y0, x0), in place: bf16(silu(float(x)*a + b)) for every in-image
// pixel and channel below C (C a multiple of 8: a unit is all in or all
// out); the rest keeps the zeros of the copies. Thread tid takes channel unit
// tid % UNITS of pixels tid / UNITS, + NTHREADS / UNITS, ...; ab: this
// image's [2, C] affine, whose 8 a and 8 b of the unit the thread reads at
// each of its (at most 3) pixels, from L1. silu(v) = v / (1 + e^-v) with
// __expf and a division by the MUFU reciprocal (1 + e^-v = inf gives -0).
__device__ __forceinline__ void gn_silu_pass(bf16* Xb, const float* __restrict__ ab, int c0,
                                             int C, int y0, int x0, int H, int W, int tid) {
  constexpr int UNITS = BK / 8, STEP = MmaTile::NTHREADS / UNITS;
  const int u = (tid % UNITS) * 8, c = c0 + u;
  if (c >= C) return;
  for (int p = tid / UNITS; p < HALO_PX; p += STEP) {
    const int iy = y0 - 1 + p / HXW, ix = x0 - 1 + p % HXW;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
    float a[8], s[8];
    *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(ab + c);
    *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(ab + c + 4);
    *reinterpret_cast<float4*>(s) = *reinterpret_cast<const float4*>(ab + C + c);
    *reinterpret_cast<float4*>(s + 4) = *reinterpret_cast<const float4*>(ab + C + c + 4);
    uint4* q = reinterpret_cast<uint4*>(Xb + p * KROW + u);
    uint4 v = *q;
    uint32_t* e = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float lo = __uint_as_float(e[k] << 16) * a[2 * k] + s[2 * k];
      const float hi = __uint_as_float(e[k] & 0xffff0000u) * a[2 * k + 1] + s[2 * k + 1];
      e[k] = pack_bf16(__fdividef(lo, 1.f + __expf(-lo)), __fdividef(hi, 1.f + __expf(-hi)));
    }
    *q = v;
  }
}

// The halo form: grid (ceil(O / BN), B * ceil(H / HTH) * ceil(W / HTW),
// splits): one HTH x HTW output tile of one image over split blockIdx.z's
// channel chunks; k tiles in the order (chunk, tap), each chunk's halo
// staged once for its nine taps. FUSED (B7): each landed halo goes through
// gn_silu_pass with the image's affine (gn_ab [B, 2, C]) before its taps.
template <bool FUSED>
__device__ __forceinline__ void halo_conv(const bf16* __restrict__ x,
                                          const float* __restrict__ gn_ab,
                                          const bf16* __restrict__ w,
                                          const float* __restrict__ bias, bf16* __restrict__ out,
                                          float* __restrict__ part, int B, int H, int W, int C,
                                          int O) {
  using T = MmaTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int X_ELEMS = HALO_PX * KROW;     // one halo buffer
  constexpr int UNITS = BK / 8;               // 16-byte units a halo pixel
  bf16* Xs = smem;                            // two halo buffers
  bf16* Ws = smem + 2 * X_ELEMS;              // the weight ring
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_w = (W + HTW - 1) / HTW, tiles = (H + HTH - 1) / HTH * tiles_w;
  const int b = blockIdx.y / tiles, tile = blockIdx.y % tiles;
  const int y0 = tile / tiles_w * HTH, x0 = tile % tiles_w * HTW;
  const int n0 = blockIdx.x * T::BN;
  const bf16* xb = x + (long)b * H * W * C;
  const float* ab = FUSED ? gn_ab + (long)b * 2 * C : nullptr;
  const Chunks ch(C, blockIdx.z, gridDim.z);

  // Channels [c0, c0 + BK) of the halo, rows y0-1 .. y0+HTH, columns
  // x0-1 .. x0+HTW -> halo buffer `buf` ([HALO_PX][KROW]); zeros off the
  // image and past C. The caller commits.
  auto stage_halo = [&](int buf, int c0) {
    bf16* dst = Xs + buf * X_ELEMS;
    for (int i = tid; i < HALO_PX * UNITS; i += T::NTHREADS) {
      const int p = i / UNITS, u = (i % UNITS) * 8;
      const int iy = y0 - 1 + p / HXW, ix = x0 - 1 + p % HXW;
      const bool ok = c0 + u < C && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const bf16* src = ok ? xb + ((long)iy * W + ix) * C + c0 + u : x;
      cp_async_16(smem_addr(dst + p * KROW + u), src, ok);
    }
  };

  // this lane's A rows: tile row m is halo pixel (m / HTW, m % HTW) at tap (0, 0)
  uint32_t a_lane[T::MT];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    const int m = (warp / T::WN) * T::MT * 16 + mt * 16 + lane % 16;
    a_lane[mt] = smem_addr(Xs + (m / HTW * HXW + m % HTW) * KROW + lane / 16 * 8);
  }
  const uint32_t b_lane = weight_lane_addr<T>(Ws, lane, warp);
  float acc[T::MT][T::NT][4];
  zero<T>(acc);

  // Step s is chunk c_lo + s / 9, tap s % 9; its weight tile is in the
  // commit group of step s, the halo of the split's chunk j + 1 in the group
  // of step 9j (STAGES <= 9: landed before step 9(j + 1) waits, and by step
  // 9j + STAGES - 1).
  const int KT = 9 * ch.nc;
  stage_halo(0, ch.c_lo * BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_w<T>(Ws + s * T::W_ELEMS, w, s % 9, (ch.c_lo + s / 9) * BK, n0, C, O, tid);
    cp_async_commit();
  }
  if constexpr (FUSED) {
    cp_async_wait<STAGES - 2>();       // the first chunk's halo (commit group 0) has landed
    __syncthreads();
    gn_silu_pass(Xs, ab, ch.c_lo * BK, C, y0, x0, H, W, tid);
  }
  for (int s = 0; s < KT; ++s) {
    const int j = s / 9, tap = s - 9 * j;
    cp_async_wait<STAGES - 2>();       // step s's weight tile and chunk j's halo have landed
    __syncthreads();                   // ... every thread's; step s-1's buffers are read
    const int nx = s + STAGES - 1;
    if (nx < KT)
      load_w<T>(Ws + nx % STAGES * T::W_ELEMS, w, nx % 9, (ch.c_lo + nx / 9) * BK, n0, C, O, tid);
    if (tap == 0 && j + 1 < ch.nc)     // its buffer was read last in chunk j - 1
      stage_halo((j + 1) % 2, (ch.c_lo + j + 1) * BK);
    cp_async_commit();
    if constexpr (FUSED) {
      // chunk j + 1's halo, landed; read first after step 9(j + 1)'s barrier
      if (tap == PASS_TAP && j + 1 < ch.nc)
        gn_silu_pass(Xs + (j + 1) % 2 * X_ELEMS, ab, (ch.c_lo + j + 1) * BK, C, y0, x0, H, W,
                     tid);
    }
    const uint32_t xo = ((j % 2) * X_ELEMS + (tap / 3 * HXW + tap % 3) * KROW) * 2;
    uint32_t a[T::MT];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) a[mt] = a_lane[mt] + xo;
    tile_product<T>(acc, a, b_lane + s % STAGES * T::W_ELEMS * 2);
  }
  cp_async_wait<0>();
  __syncthreads();
  store_tile<T>(acc, smem, bias, out, part, blockIdx.z, gridDim.z, (long)B * H * W, n0, O,
                HaloRows{b, y0, x0, H, W}, tid);
}

__global__ void __launch_bounds__(MmaTile::NTHREADS, MIN_BLOCKS)
conv3x3_halo_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ bias, bf16* __restrict__ out,
                        float* __restrict__ part, int B, int H, int W, int C, int O) {
  halo_conv<false>(x, nullptr, w, bias, out, part, B, H, W, C, O);
}

// B7's conv; gn_ab: the statistics kernel's [B, 2, C] affine
__global__ void __launch_bounds__(MmaTile::NTHREADS, MIN_BLOCKS)
gn_silu_conv3x3_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ gn_ab,
                           const bf16* __restrict__ w, const float* __restrict__ bias,
                           bf16* __restrict__ out, float* __restrict__ part, int B, int H, int W,
                           int C, int O) {
  halo_conv<true>(x, gn_ab, w, bias, out, part, B, H, W, C, O);
}

// out = bf16(part[0] + ... + part[splits - 1] + bias), summed in that order
// (no atomics: two calls give equal bits), 8 values a thread.
__device__ __forceinline__ void split_sum(const float* __restrict__ part,
                                          const float* __restrict__ bias, bf16* __restrict__ out,
                                          long MO, int O, int splits) {
  const long e = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (e >= MO) return;
  float4 lo = *reinterpret_cast<const float4*>(part + e);
  float4 hi = *reinterpret_cast<const float4*>(part + e + 4);
  for (int s = 1; s < splits; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(part + s * MO + e);
    const float4 c = *reinterpret_cast<const float4*>(part + s * MO + e + 4);
    lo = make_float4(lo.x + a.x, lo.y + a.y, lo.z + a.z, lo.w + a.w);
    hi = make_float4(hi.x + c.x, hi.y + c.y, hi.z + c.z, hi.w + c.w);
  }
  const float* bb = bias + e % O;
  *reinterpret_cast<uint4*>(out + e) =
      make_uint4(pack_bf16(lo.x + bb[0], lo.y + bb[1]), pack_bf16(lo.z + bb[2], lo.w + bb[3]),
                 pack_bf16(hi.x + bb[4], hi.y + bb[5]), pack_bf16(hi.z + bb[6], hi.w + bb[7]));
}

// The sum kernel of each conv (three names, so that a profile files each
// under its wrapper)
__global__ void conv3x3_im2col_sum_kernel(const float* __restrict__ part,
                                          const float* __restrict__ bias, bf16* __restrict__ out,
                                          long MO, int O, int splits) {
  split_sum(part, bias, out, MO, O, splits);
}

__global__ void conv3x3_halo_sum_kernel(const float* __restrict__ part,
                                        const float* __restrict__ bias, bf16* __restrict__ out,
                                        long MO, int O, int splits) {
  split_sum(part, bias, out, MO, O, splits);
}

__global__ void gn_silu_conv3x3_sum_kernel(const float* __restrict__ part,
                                           const float* __restrict__ bias,
                                           bf16* __restrict__ out, long MO, int O, int splits) {
  split_sum(part, bias, out, MO, O, splits);
}

// ---------------------------------------------------------------------------
// B7's statistics

constexpr int STATS_THREADS = 1024;

// The sum of v over the block, in a fixed order (a shuffle tree in each
// warp, then the warps' sums in order); every thread returns it. red: 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int k = 0; k < blockDim.x / 32; ++k) t += red[k];
  __syncthreads();                     // red is free again
  return t;
}

// V bf16 as one load
template <int V> struct Piece;
template <> struct Piece<8> { using T = uint4; };
template <> struct Piece<4> { using T = uint2; };
template <> struct Piece<2> { using T = uint32_t; };
template <> struct Piece<1> { using T = unsigned short; };

// f(float(v)) for the `rep` channels at xg of each of n pixels (stride C),
// as pieces of V channels: thread t takes piece t % U (U = rep / V) of pixels
// t / U, + R, ... (R = blockDim / U), in that order.
template <int V, class F>
__device__ __forceinline__ void group_walk(const bf16* __restrict__ xg, int n, int C, int rep,
                                           F f) {
  const int U = rep / V, R = blockDim.x / U, t = threadIdx.x;
  if (t >= U * R) return;
  const bf16* x0 = xg + (t % U) * V;
#pragma unroll 4
  for (int p = t / U; p < n; p += R) {
    const typename Piece<V>::T raw =
        *reinterpret_cast<const typename Piece<V>::T*>(x0 + (long)p * C);
    const unsigned short* h = reinterpret_cast<const unsigned short*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) f(__uint_as_float((uint32_t)h[e] << 16));
  }
}

// group_walk with the widest piece the group's alignment allows (the group
// starts at channel g*rep, and C = groups*rep)
template <class F>
__device__ __forceinline__ void group_walk_any(const bf16* __restrict__ xg, int n, int C,
                                               int rep, F f) {
  if (rep % 8 == 0) group_walk<8>(xg, n, C, rep, f);
  else if (rep % 4 == 0) group_walk<4>(xg, n, C, rep, f);
  else if (rep % 2 == 0) group_walk<2>(xg, n, C, rep, f);
  else group_walk<1>(xg, n, C, rep, f);
}

// grid (B * groups): block (b, g) writes a and b of the group's channels
// into ab [B, 2, C]: the mean over the group's n = HW*rep values first, the
// variance about it in a second pass, inv = rsqrt(var + eps), a = inv*gs,
// b = gb - (mean*inv)*gs.
__global__ void __launch_bounds__(STATS_THREADS)
gn_silu_conv3x3_stats_kernel(const bf16* __restrict__ x, const float* __restrict__ gs,
                             const float* __restrict__ gb, float* __restrict__ ab, int HW, int C,
                             int groups, float eps) {
  __shared__ float red[32];
  const int b = blockIdx.x / groups, g = blockIdx.x % groups, rep = C / groups;
  const bf16* xg = x + (long)b * HW * C + g * rep;
  const float count = (float)HW * rep;
  float sum = 0.f;
  group_walk_any(xg, HW, C, rep, [&](float v) { sum += v; });
  const float mean = block_sum(sum, red) / count;
  float sq = 0.f;
  group_walk_any(xg, HW, C, rep, [&](float v) { const float d = v - mean; sq += d * d; });
  const float inv = rsqrtf(block_sum(sq, red) / count + eps);
  const float shift = mean * inv;
  float* abb = ab + (long)b * 2 * C;
  for (int k = threadIdx.x; k < rep; k += blockDim.x) {
    const int c = g * rep + k;
    abb[c] = inv * gs[c];
    abb[C + c] = gb[c] - shift * gs[c];
  }
}

// ---------------------------------------------------------------------------
// Launches

constexpr int SUM_THREADS = 256;

dim3 im2col_grid(int B, int H, int W, int O, int splits) {
  return dim3((O + MmaTile::BN - 1) / MmaTile::BN,
              (int)(((long)B * H * W + MmaTile::BM - 1) / MmaTile::BM), splits);
}

dim3 halo_grid(int B, int H, int W, int O, int splits) {
  return dim3((O + MmaTile::BN - 1) / MmaTile::BN,
              (int)((long)B * ((H + HTH - 1) / HTH) * ((W + HTW - 1) / HTW)), splits);
}

bool mma_args_ok(int B, int H, int W, int C, int O, int splits, dim3 grid) {
  return B > 0 && H > 0 && W > 0 && C > 0 && O > 0 && C % 8 == 0 && O % 8 == 0
         && splits >= 1 && splits <= MAX_SPLITS && splits <= (C + BK - 1) / BK
         && (long)B * H * W <= (long)MmaTile::BM * 65535 && grid.y <= 65535;
}

bool gn_args_ok(int B, int H, int W, int C, int O, int groups, int splits, dim3 grid) {
  return mma_args_ok(B, H, W, C, O, splits, grid) && groups > 0 && C % groups == 0
         && (long)B * groups <= 0x7fffffff;
}

// B7's workspace: the [B, 2, C] affine, then (with several splits) the
// splits' fp32 sums, 256-byte aligned.
struct GnWorkspace {
  long long part, total;    // byte offset of the sums, bytes in all
  GnWorkspace(int B, int H, int W, int C, int O, int splits) {
    part = ((long long)B * 2 * C * 4 + 255) / 256 * 256;
    total = part + (splits > 1 ? (long long)splits * B * H * W * O * 4 : 0);
  }
};

// Each main kernel takes more than 48 KB of dynamic shared memory; set once.
cudaError_t set_smem_limits() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_im2col_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         IM2COL_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv3x3_halo_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, HALO_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gn_silu_conv3x3_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, HALO_SMEM);
    return e;
  }();
  return err;
}

using MmaKernel = void (*)(const bf16*, const bf16*, const float*, bf16*, float*, int, int, int,
                           int, int);
using SumKernel = void (*)(const float*, const float*, bf16*, long, int, int);

// With several splits, the sum kernel over `part`.
int launch_sum(SumKernel sum, const float* part, const void* bias, void* out, long mo, int O,
               int splits, cudaStream_t stream) {
  if (splits == 1) return 0;
  sum<<<(unsigned)((mo / 8 + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0, stream>>>(
      part, static_cast<const float*>(bias), static_cast<bf16*>(out), mo, O, splits);
  return (int)cudaGetLastError();
}

// B8 or B9: the main kernel over `grid` and, with several splits, the sum kernel.
int launch_mma(MmaKernel kernel, SumKernel sum, int smem, dim3 grid, const void* x,
               const void* w, const void* bias, void* out, void* part, int B, int H, int W,
               int C, int O, cudaStream_t stream) {
  if (grid.z > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_limits();
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, MmaTile::NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(part), B, H, W, C, O);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum(sum, static_cast<const float*>(part), bias, out, (long)B * H * W * O, O,
                    (int)grid.z, stream);
}

int launch_stats(const void* x, const void* gs, const void* gb, float* ab, int B, int HW, int C,
                 int groups, float eps, cudaStream_t stream) {
  gn_silu_conv3x3_stats_kernel<<<B * groups, STATS_THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gs), static_cast<const float*>(gb),
      ab, HW, C, groups, eps);
  return (int)cudaGetLastError();
}

// info[0..6] of `kernel` at `grid`: registers a thread, shared memory a block
// (bytes: dynamic `smem` plus static), the tile (tile0 x tile1), resident
// blocks an SM, blocks in the grid, local memory a thread (bytes).
template <class K>
cudaError_t describe_one(K kernel, int threads, int smem, int tile0, int tile1, dim3 grid,
                         int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = set_smem_limits();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  info[0] = attr.numRegs;
  info[1] = smem + (int)attr.sharedSizeBytes;
  info[2] = tile0;
  info[3] = tile1;
  info[4] = blocks;
  info[5] = (int)(grid.x * grid.y * grid.z);
  info[6] = (int)attr.localSizeBytes;
  return err;
}

}  // namespace

// Each returns a cudaError_t code: 0 when the launches were accepted.

// The bytes of B7's workspace at this shape and split count.
extern "C" int gn_silu_conv_workspace(int B, int H, int W, int C, int O, int groups, int splits,
                                      long long* bytes) {
  if (!gn_args_ok(B, H, W, C, O, groups, splits, halo_grid(B, H, W, O, splits)))
    return (int)cudaErrorInvalidValue;
  *bytes = GnWorkspace(B, H, W, C, O, splits).total;
  return 0;
}

// B7: x [B, H, W, C] bf16, gs, gb [C] f32 (the GroupNorm's scale and shift),
// the packed weight [9, C, O], bias [O] f32, out [B, H, W, O]; C and O
// multiples of 8, C of `groups`; `work`: gn_silu_conv_workspace bytes,
// 256-byte aligned. The statistics kernel, the conv over `splits` parts of
// the channel chunks, and with several parts their sum, back to back on
// `stream`.
extern "C" int gn_silu_conv3x3_halo_fwd(const void* x, const void* gs, const void* gb,
                                        const void* w, const void* bias, void* out, void* work,
                                        int B, int H, int W, int C, int O, int groups, float eps,
                                        int splits, void* stream) {
  const dim3 grid = halo_grid(B, H, W, O, splits);
  if (!gn_args_ok(B, H, W, C, O, groups, splits, grid) || work == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_limits();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ab = static_cast<float*>(work);
  float* part = reinterpret_cast<float*>(static_cast<char*>(work)
                                         + GnWorkspace(B, H, W, C, O, splits).part);
  int e = launch_stats(x, gs, gb, ab, B, H * W, C, groups, eps, st);
  if (e != 0) return e;
  gn_silu_conv3x3_mma_kernel<<<grid, MmaTile::NTHREADS, HALO_SMEM, st>>>(
      static_cast<const bf16*>(x), ab, static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), part, B, H, W, C, O);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum(gn_silu_conv3x3_sum_kernel, part, bias, out, (long)B * H * W * O, O, splits,
                    st);
}

// B7's statistics kernel alone: its [B, 2, C] f32 affine into `ab`.
extern "C" int gn_silu_conv_stats(const void* x, const void* gs, const void* gb, void* ab, int B,
                                  int H, int W, int C, int groups, float eps, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 != 0 || groups <= 0 || C % groups != 0)
    return (int)cudaErrorInvalidValue;
  return launch_stats(x, gs, gb, static_cast<float*>(ab), B, H * W, C, groups, eps,
                      static_cast<cudaStream_t>(stream));
}

// B8 and B9: x [B, H, W, C], the packed weight [9, C, O], bias [O] f32, out
// [B, H, W, O]; C and O multiples of 8; the channel chunks in `splits` parts
// (1 to 4, at most one a chunk of 32), each part's fp32 sums in `part`
// ([splits, B*H*W, O] f32; unused with one part), summed by a second kernel.
extern "C" int conv3x3_halo_fwd(const void* x, const void* w, const void* bias, void* out,
                                void* part, int B, int H, int W, int C, int O, int splits,
                                void* stream) {
  const dim3 grid = halo_grid(B, H, W, O, splits);
  if (!mma_args_ok(B, H, W, C, O, splits, grid)) return (int)cudaErrorInvalidValue;
  return launch_mma(conv3x3_halo_mma_kernel, conv3x3_halo_sum_kernel, HALO_SMEM, grid, x, w,
                    bias, out, part, B, H, W, C, O, static_cast<cudaStream_t>(stream));
}

extern "C" int conv3x3_im2col_fwd(const void* x, const void* w, const void* bias, void* out,
                                  void* part, int B, int H, int W, int C, int O, int splits,
                                  void* stream) {
  const dim3 grid = im2col_grid(B, H, W, O, splits);
  if (!mma_args_ok(B, H, W, C, O, splits, grid)) return (int)cudaErrorInvalidValue;
  return launch_mma(conv3x3_im2col_mma_kernel, conv3x3_im2col_sum_kernel, IM2COL_SMEM, grid, x,
                    w, bias, out, part, B, H, W, C, O, static_cast<cudaStream_t>(stream));
}

// Fills info[0..6] for B8's main kernel at `halo_splits` and info[7..13] for
// B9's at `im2col_splits`, at this shape: registers a thread, shared memory a
// block (bytes), pixels and channels a tile, resident blocks an SM, blocks in
// the grid, local memory a thread (bytes). (The sum kernels hold 8 values a
// thread and no shared memory.)
extern "C" int conv_halo_describe(int B, int H, int W, int C, int O, int halo_splits,
                                  int im2col_splits, int* info) {
  const dim3 halo = halo_grid(B, H, W, O, halo_splits);
  const dim3 im2col = im2col_grid(B, H, W, O, im2col_splits);
  if (!mma_args_ok(B, H, W, C, O, halo_splits, halo)
      || !mma_args_ok(B, H, W, C, O, im2col_splits, im2col))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = describe_one(conv3x3_halo_mma_kernel, MmaTile::NTHREADS, HALO_SMEM,
                                 MmaTile::BM, MmaTile::BN, halo, info);
  if (err != cudaSuccess) return (int)err;
  return (int)describe_one(conv3x3_im2col_mma_kernel, MmaTile::NTHREADS, IM2COL_SMEM,
                           MmaTile::BM, MmaTile::BN, im2col, info + 7);
}

// B7's twin: info[0..6] for its main kernel at `splits`, info[7..13] for its
// statistics kernel (the "tile" there: pixels and channels a block).
extern "C" int gn_silu_conv_describe(int B, int H, int W, int C, int O, int groups, int splits,
                                     int* info) {
  const dim3 grid = halo_grid(B, H, W, O, splits);
  if (!gn_args_ok(B, H, W, C, O, groups, splits, grid)) return (int)cudaErrorInvalidValue;
  cudaError_t err = describe_one(gn_silu_conv3x3_mma_kernel, MmaTile::NTHREADS, HALO_SMEM,
                                 MmaTile::BM, MmaTile::BN, grid, info);
  if (err != cudaSuccess) return (int)err;
  return (int)describe_one(gn_silu_conv3x3_stats_kernel, STATS_THREADS, 0, H * W, C / groups,
                           dim3(B * groups), info + 7);
}
