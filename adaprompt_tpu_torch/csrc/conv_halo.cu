// 3x3 stride-1 SAME convolutions over NHWC activations for Hopper (sm_90a),
// as implicit matrix products on the tensor cores:
//   * gn_silu_conv3x3_halo_fwd: conv3x3(SiLU(GroupNorm(x))) + bias, the
//     GroupNorm folded into a per-(batch, channel) affine a, b that the
//     caller computes: the normalized, activated tensor never touches device
//     memory. Replaces adaprompt_tpu/ops/conv_halo.py::gn_silu_conv3x3_halo.
//   * conv3x3_halo_fwd: the same conv without the producer, nine tap
//     products accumulated. Replaces conv_halo.py::conv3x3_halo.
//   * conv3x3_im2col_fwd: the same conv with the nine taps laid side by side
//     in a [pixels, 9*chunk] patch tile in shared memory and contracted in
//     ONE product per channel chunk. Replaces conv_halo.py::conv3x3_im2col.
//
// Layouts: x [B, H, W, C] bf16; gn_ab [B, 2, C] f32 (a then b); w [9, C, O]
// bf16, taps outermost (tap = 3*dy + dx), which read as [9C, O] is the
// im2col weight; bias [O] f32; out [B, H, W, O] bf16.
//
// Arithmetic of the fused producer, as the TPU kernel's: seg = float(x)*a+b,
// seg*sigmoid(seg) in f32, ROUNDED TO bf16, and exactly 0 outside the image
// (SAME padding pads the activated tensor; padding x itself would put
// silu(b) != 0 on the border). The mask is by image row and column. Products
// accumulate in f32, the bias is added in f32, the result is cast to bf16.
//
// What bounds it: 18*B*H*W*C*O flops against 2*B*H*W*(C+O) + 18*C*O bytes:
// at the SD-1.5 shapes hundreds of flops a byte, so the tensor cores bound
// it. Design: a block computes an 8-row x 16-column x 64-channel output
// tile, one warp per row (one 16-pixel WMMA row fragment, four 16x16 f32
// accumulators in registers). It loops over the input channels in chunks of
// 32: the (8+2) x (16+2) x 32 halo tile of x is staged into shared memory
// with predicated loads that write zeros off the image (no padded copy of x
// exists anywhere) and, fused, with the affine and SiLU applied on the way;
// the chunk's [9, 32, 64] weight slice is staged beside it. The nine taps
// are then nine shifted reads of that one staged tile. Every block re-reads
// its weight slice and its halo from L2; larger tiles, a cp.async/TMA ring
// and wgmma are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8;              // output rows per block: one warp each
constexpr int TW = 16;             // output columns per block: one WMMA row fragment
constexpr int OT = 64;             // output channels per block
constexpr int CK = 32;             // input channels per chunk
constexpr int NWARPS = TH;
constexpr int NTHREADS = NWARPS * 32;
constexpr int XW = TW + 2;         // staged tile width, halo included
constexpr int CKP = CK + 16;       // staged pixel stride (elements): 96 bytes, so that
                                   // four consecutive pixels fill the 32 banks once
constexpr int OTP = OT + 16;       // staged weight row stride: 160 bytes, likewise
constexpr int KP = 9 * CK + 16;    // im2col patch row stride: 608 bytes, likewise
constexpr int NT = OT / 16;        // accumulator fragments per warp

constexpr int XS_ELEMS = (TH + 2) * XW * CKP;
constexpr int WS_ELEMS = 9 * CK * OTP;
constexpr int PS_ELEMS = TH * TW * KP;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

static_assert(NWARPS * 16 * OT * 4 <= WS_ELEMS * 2, "epilogue scratch aliases the weight tile");

// Stage the halo tile of channels [c0, c0+CK) into Xs[(TH+2)][XW][CKP]: rows
// y0-1 .. y0+TH, columns x0-1 .. x0+TW of image `xb`. Pixels off the image
// and channels >= C become 0. FUSED applies a*x+b, SiLU and the bf16 rounding.
template <bool FUSED>
__device__ __forceinline__ void stage_x(bf16* Xs, const bf16* __restrict__ xb,
                                        const float* __restrict__ ab, int H, int W, int C,
                                        int y0, int x0, int c0, bool vec) {
  constexpr int G = CK / 8;
  for (int i = threadIdx.x; i < (TH + 2) * XW * G; i += NTHREADS) {
    const int p = i / G, g = i % G;
    const int iy = y0 + p / XW - 1, ix = x0 + p % XW - 1, c = c0 + g * 8;
    __align__(16) bf16 v[8];
    const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W && c < C;
    if (inside) {
      const bf16* src = xb + ((long)iy * W + ix) * C + c;
      if (vec && c + 8 <= C) {
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = c + e < C ? src[e] : __float2bfloat16(0.f);
      }
      if (FUSED) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (c + e < C) {
            const float seg = __bfloat162float(v[e]) * ab[c + e] + ab[C + c + e];
            v[e] = __float2bfloat16(seg / (1.f + expf(-seg)));
          }
        }
      }
    } else {
      *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
    }
    *reinterpret_cast<uint4*>(Xs + p * CKP + g * 8) = *reinterpret_cast<const uint4*>(v);
  }
}

// Stage w[:, c0:c0+CK, o0:o0+OT] into Ws[9][CK][OTP] (zeros past C and O).
__device__ __forceinline__ void stage_w(bf16* Ws, const bf16* __restrict__ w, int C, int O,
                                        int c0, int o0, bool vec) {
  constexpr int G = OT / 8;
  for (int i = threadIdx.x; i < 9 * CK * G; i += NTHREADS) {
    const int row = i / G, g = i % G;          // row = tap * CK + k
    const int tap = row / CK, c = c0 + row % CK, o = o0 + g * 8;
    __align__(16) bf16 v[8];
    if (c < C && o < O) {
      const bf16* src = w + ((long)tap * C + c) * O + o;
      if (vec && o + 8 <= O) {
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = o + e < O ? src[e] : __float2bfloat16(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
    }
    *reinterpret_cast<uint4*>(Ws + row * OTP + g * 8) = *reinterpret_cast<const uint4*>(v);
  }
}

// acc (this warp's output row y0+warp, 16 pixels x OT channels) + bias -> out.
// `scratch` is NWARPS*16*OT floats that no warp still reads as anything else.
__device__ __forceinline__ void write_out(FragC* acc, float* scratch,
                                          const float* __restrict__ bias,
                                          bf16* __restrict__ outb, int H, int W, int O, int y0,
                                          int x0, int o0, bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* St = scratch + warp * 16 * OT;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    wmma::store_matrix_sync(St + j * 16, acc[j], OT, wmma::mem_row_major);
  __syncwarp();
  const int iy = y0 + warp;
  if (iy >= H) return;
  constexpr int G = OT / 8;
  for (int i = lane; i < 16 * G; i += 32) {
    const int px = i / G, g = i % G;
    const int ix = x0 + px, o = o0 + g * 8;
    if (ix >= W || o >= O) continue;
    bf16* dst = outb + ((long)iy * W + ix) * O + o;
    const float* s = St + px * OT + g * 8;
    if (vec && o + 8 <= O) {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(s[e] + bias[o + e]);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int e = 0; e < 8 && o + e < O; ++e) dst[e] = __float2bfloat16(s[e] + bias[o + e]);
    }
  }
}

struct Tile {
  int y0, x0, o0;
  long b;
};

__device__ __forceinline__ Tile block_tile(int W) {
  const int tiles_w = (W + TW - 1) / TW;
  Tile t;
  t.y0 = (blockIdx.x / tiles_w) * TH;
  t.x0 = (blockIdx.x % tiles_w) * TW;
  t.o0 = blockIdx.y * OT;
  t.b = blockIdx.z;
  return t;
}

// Nine tap products per chunk, each a shifted read of the staged tile.
template <bool FUSED>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_halo_kernel(const bf16* __restrict__ x, const float* __restrict__ gn_ab,
                    const bf16* __restrict__ w, const float* __restrict__ bias,
                    bf16* __restrict__ out, int H, int W, int C, int O) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ws = Xs + XS_ELEMS;
  const Tile t = block_tile(W);
  const int warp = threadIdx.x / 32;
  const bf16* xb = x + t.b * H * W * C;
  const float* ab = FUSED ? gn_ab + t.b * 2 * C : nullptr;
  const bool vec_c = C % 8 == 0, vec_o = O % 8 == 0;

  FragC acc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();                       // the previous chunk's reads are done
    stage_x<FUSED>(Xs, xb, ab, H, W, C, t.y0, t.x0, c0, vec_c);
    stage_w(Ws, w, C, O, c0, t.o0, vec_o);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* a0 = Xs + ((warp + tap / 3) * XW + tap % 3) * CKP;
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, a0 + kk, CKP);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, Ws + (tap * CK + kk) * OTP + j * 16, OTP);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
  }
  __syncthreads();                         // every warp is done with Ws
  write_out(acc, reinterpret_cast<float*>(Ws), bias, out + t.b * H * W * O, H, W, O, t.y0, t.x0,
            t.o0, vec_o);
}

// The nine taps side by side in a [TH*TW, 9*CK] patch tile, then one product
// of depth 9*CK per chunk against the [9*CK, OT] weight slice.
__global__ void __launch_bounds__(NTHREADS)
conv3x3_im2col_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ bias, bf16* __restrict__ out, int H, int W,
                      int C, int O) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ws = Xs + XS_ELEMS;
  bf16* Ps = Ws + WS_ELEMS;
  const Tile t = block_tile(W);
  const int warp = threadIdx.x / 32;
  const bf16* xb = x + t.b * H * W * C;
  const bool vec_c = C % 8 == 0, vec_o = O % 8 == 0;

  FragC acc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[j], 0.f);

  constexpr int G = CK / 8;
  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();
    stage_x<false>(Xs, xb, nullptr, H, W, C, t.y0, t.x0, c0, vec_c);
    stage_w(Ws, w, C, O, c0, t.o0, vec_o);
    __syncthreads();
    // patches[m][tap*CK + k] = tile[r + dy][col + dx][k], m = r*TW + col
    for (int i = threadIdx.x; i < TH * TW * 9 * G; i += NTHREADS) {
      const int m = i / (9 * G), rem = i % (9 * G);
      const int tap = rem / G, g = rem % G;
      const bf16* src = Xs + ((m / TW + tap / 3) * XW + m % TW + tap % 3) * CKP + g * 8;
      *reinterpret_cast<uint4*>(Ps + m * KP + tap * CK + g * 8) =
          *reinterpret_cast<const uint4*>(src);
    }
    __syncthreads();
#pragma unroll 6
    for (int kk = 0; kk < 9 * CK; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, Ps + warp * 16 * KP + kk, KP);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, Ws + kk * OTP + j * 16, OTP);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();
  write_out(acc, reinterpret_cast<float*>(Ws), bias, out + t.b * H * W * O, H, W, O, t.y0, t.x0,
            t.o0, vec_o);
}

bool bad_shape(int B, int H, int W, int C, int O) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || B > 65535 || (O + OT - 1) / OT > 65535;
}

dim3 grid_of(int B, int H, int W, int O) {
  return dim3(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (O + OT - 1) / OT, B);
}

template <bool FUSED>
int launch_halo(const void* x, const void* gn_ab, const void* w, const void* bias, void* out,
                int B, int H, int W, int C, int O, void* stream) {
  if (bad_shape(B, H, W, C, O)) return (int)cudaErrorInvalidValue;
  const int smem = (XS_ELEMS + WS_ELEMS) * 2;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_halo_kernel<FUSED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv3x3_halo_kernel<FUSED><<<grid_of(B, H, W, O), NTHREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gn_ab), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, C, O);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int gn_silu_conv3x3_halo_fwd(const void* x, const void* gn_ab, const void* w,
                                        const void* bias, void* out, int B, int H, int W, int C,
                                        int O, void* stream) {
  return launch_halo<true>(x, gn_ab, w, bias, out, B, H, W, C, O, stream);
}

extern "C" int conv3x3_halo_fwd(const void* x, const void* w, const void* bias, void* out, int B,
                                int H, int W, int C, int O, void* stream) {
  return launch_halo<false>(x, nullptr, w, bias, out, B, H, W, C, O, stream);
}

extern "C" int conv3x3_im2col_fwd(const void* x, const void* w, const void* bias, void* out,
                                  int B, int H, int W, int C, int O, void* stream) {
  if (bad_shape(B, H, W, C, O)) return (int)cudaErrorInvalidValue;
  const int smem = (XS_ELEMS + WS_ELEMS + PS_ELEMS) * 2;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_im2col_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv3x3_im2col_kernel<<<grid_of(B, H, W, O), NTHREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), H, W, C, O);
  return (int)cudaGetLastError();
}
