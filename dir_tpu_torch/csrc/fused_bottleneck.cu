// Fused stride-1 ResNet bottleneck at inference, bf16 in and out, for Hopper
// (sm_90a).
//
// Replaces dir_tpu/ops/pallas_bottleneck.py:fused_bottleneck_infer (the
// whole-map Pallas `_kernel`, math in `_bottleneck_body`). Computes, with BN
// folded into the weights beforehand:
//   y1  = bf16(relu(x . w1 + b1))            zero in the 3x3 halo outside the image
//   y2  = bf16(relu(conv3x3(y1, w2) + b2))
//   y3  = bf16(y2 . w3 + b3)
//   res = x, or bf16(x . wd + bd) for the projection form
//   out = bf16(relu(y3 + res))
// with bf16 operands and fp32 accumulation; biases are fp32.
//
// What bounds it on an H100: at the layer1 shape the main path gives it
// (B, 64, 64, 256), mid 64, out 256, the block input and output are
// B * 64*64 * (256 + 256) * 2 bytes (1.07 GB at B = 256, 0.32 ms at
// 3.35 TB/s), against 2*B*4096*(256*64 + 9*64*64 + 64*256) = 146 GFLOP
// (0.15 ms at 989 TFLOP/s): it is bound by device-memory bytes.
//
// What the design does about it: the intermediates y1 and y2 never leave
// shared memory, so device memory sees the block input and output once (plus
// the halo's re-read, mostly from L2). One thread block of 16 warps owns an
// 8x16 tile of output pixels of one sample. It loads the 10x18-pixel halo of
// x (all C channels) into shared memory, runs conv1 on the halo, conv2 as
// nine shifted K=mid products over rows of the halo (a tile 16 pixels wide
// makes every 3x3 tap a contiguous 16-row operand), then conv3 and the
// residual. The products are WMMA bf16 fragments with fp32 accumulation on
// the tensor cores. Each phase's folded weights are staged in shared memory
// with 16-byte copies, and every warp keeps one weight fragment in registers
// across all the row tiles it owns. The halo costs 1.4x the input pixels and
// 1.5x conv1's products; wgmma, TMA, and overlapping one tile's loads with
// another's math are left for later work.
//
// C interface (bound with ctypes): fused_bottleneck_bf16 launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;                     // output rows per block
constexpr int TW = 16;                    // output columns per block: one WMMA row tile
constexpr int HALO_W = TW + 2;            // 18
constexpr int HALO = (TH + 2) * HALO_W;   // 180 halo pixels
constexpr int HALO_TILES = 12;            // 16-row tiles covering the halo
constexpr int HALO_PAD = HALO_TILES * 16; // 192
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int SKEW = 16;                  // row padding (bf16 elements): rows stay 32-byte aligned
constexpr int MAX_SMEM = 232448;          // H100: 227 KB of dynamic shared memory per block

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<unsigned*>(&t);
  }
  return u;
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const __nv_bfloat162* t = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(t[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// rows x cols bf16 (row-major, cols a multiple of 8) from device memory into
// shared memory rows of stride ldd, 16 bytes per thread and step.
__device__ __forceinline__ void stage_rows(bf16* dst, int ldd, const bf16* src,
                                           int rows, int cols) {
  const int cv = cols / 8;
  for (int i = threadIdx.x; i < rows * cv; i += THREADS) {
    const int r = i / cv;
    const int v = i - r * cv;
    *reinterpret_cast<uint4*>(dst + r * ldd + v * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * cols + v * 8);
  }
}

// M (mid) is a template parameter: each warp's count of accumulators follows
// from it at compile time.
template <int M>
__global__ void __launch_bounds__(THREADS, 1)
fused_bottleneck_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ w1, const float* __restrict__ b1,
                        const bf16* __restrict__ w2, const float* __restrict__ b2,
                        const bf16* __restrict__ w3, const float* __restrict__ b3,
                        const bf16* __restrict__ wd, const float* __restrict__ bd,
                        bf16* __restrict__ out, int H, int W, int C, int O,
                        int has_down, int wbuf_elems) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = C + SKEW;
  const int ldy = M + SKEW;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);          // (HALO_PAD, ldx) x halo
  bf16* y1s = xs + HALO_PAD * ldx;                        // (HALO_PAD, ldy) y1 halo
  bf16* y2s = y1s + HALO_PAD * ldy;                       // (TH * TW, ldy) y2
  bf16* wbuf = y2s + TH * TW * ldy;                       // the phase's weights
  float* stage = reinterpret_cast<float*>(wbuf + wbuf_elems);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wstage = stage + warp * 256;                     // one 16x16 fp32 tile per warp
  // epilogue: lane owns 8 consecutive columns of one row of a 16x16 tile
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const size_t n = blockIdx.z;
  const bf16* xn = x + n * H * W * C;

  // Phase 0: the x halo (zero outside the image and in the padding rows) and
  // w1 into shared memory.
  const int cv = C / 8;
  for (int i = threadIdx.x; i < HALO_PAD * cv; i += THREADS) {
    const int r = i / cv;
    const int v = i - r * cv;
    const int gy = ty0 - 1 + r / HALO_W;
    const int gx = tx0 - 1 + r % HALO_W;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < HALO && gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = *reinterpret_cast<const uint4*>(xn + ((size_t)gy * W + gx) * C + v * 8);
    *reinterpret_cast<uint4*>(xs + r * ldx + v * 8) = val;
  }
  stage_rows(wbuf, ldy, w1, C, M);
  __syncthreads();

  // Warp -> (column tile, row group) for conv1 and conv2: mid/16 divides 16.
  constexpr int mt = M / 16;
  constexpr int rgroups = WARPS / mt;
  constexpr int ACC1 = (HALO_TILES + rgroups - 1) / rgroups;
  constexpr int ACC2 = (TH + rgroups - 1) / rgroups;
  const int ct = warp % mt;
  const int g = warp / mt;

  // Phase 1: y1 = relu(x . w1 + b1) over the whole halo. A halo pixel outside
  // the image is conv2's zero padding: it is 0, not relu(b1).
  {
    FragC acc[ACC1];
#pragma unroll
    for (int i = 0; i < ACC1; ++i) wmma::fill_fragment(acc[i], 0.0f);
    for (int k = 0; k < C; k += 16) {
      FragB b;
      wmma::load_matrix_sync(b, wbuf + k * ldy + ct * 16, ldy);
#pragma unroll
      for (int i = 0; i < ACC1; ++i) {
        const int rt = g + i * rgroups;
        if (rt < HALO_TILES) {
          FragA a;
          wmma::load_matrix_sync(a, xs + rt * 16 * ldx + k, ldx);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ACC1; ++i) {
      const int rt = g + i * rgroups;
      if (rt < HALO_TILES) {
        wmma::store_matrix_sync(wstage, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = rt * 16 + er;
        const int col = ct * 16 + ec;
        const int gy = ty0 - 1 + r / HALO_W;
        const int gx = tx0 - 1 + r % HALO_W;
        const bool inside = r < HALO && gy >= 0 && gy < H && gx >= 0 && gx < W;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = inside ? fmaxf(wstage[er * 16 + ec + j] + b1[col + j], 0.0f) : 0.0f;
        *reinterpret_cast<uint4*>(y1s + r * ldy + col) = pack8(v);
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // Phase 2: y2 = relu(conv3x3(y1) + b2), one kernel row (3 taps) of w2 in
  // shared memory at a time. Output row oy, tap (dy, dx) reads the 16
  // consecutive halo rows starting at (oy + dy) * HALO_W + dx.
  {
    FragC acc[ACC2];
#pragma unroll
    for (int i = 0; i < ACC2; ++i) wmma::fill_fragment(acc[i], 0.0f);
    for (int dy = 0; dy < 3; ++dy) {
      stage_rows(wbuf, ldy, w2 + (size_t)dy * 3 * M * M, 3 * M, M);
      __syncthreads();
      for (int dx = 0; dx < 3; ++dx) {
        for (int k = 0; k < M; k += 16) {
          FragB b;
          wmma::load_matrix_sync(b, wbuf + (dx * M + k) * ldy + ct * 16, ldy);
#pragma unroll
          for (int i = 0; i < ACC2; ++i) {
            const int oy = g + i * rgroups;
            if (oy < TH) {
              FragA a;
              wmma::load_matrix_sync(a, y1s + ((oy + dy) * HALO_W + dx) * ldy + k, ldy);
              wmma::mma_sync(acc[i], a, b, acc[i]);
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < ACC2; ++i) {
      const int oy = g + i * rgroups;
      if (oy < TH) {
        wmma::store_matrix_sync(wstage, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        const int col = ct * 16 + ec;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = fmaxf(wstage[er * 16 + ec + j] + b2[col + j], 0.0f);
        *reinterpret_cast<uint4*>(y2s + (oy * 16 + er) * ldy + col) = pack8(v);
        __syncwarp();
      }
    }
  }
  const int ldw3 = O + SKEW;
  stage_rows(wbuf, ldw3, w3, M, O);
  __syncthreads();

  // Phase 3: y3 = y2 . w3 + b3 and the residual, each rounded to bf16, then
  // their bf16 sum through relu to device memory, 16 bytes per lane.
  const int ot = O / 16;
  bf16* outn = out + n * H * W * O;
  for (int oc = warp; oc < ot; oc += WARPS) {
    FragC acc[TH];
#pragma unroll
    for (int i = 0; i < TH; ++i) wmma::fill_fragment(acc[i], 0.0f);
    for (int k = 0; k < M; k += 16) {
      FragB b;
      wmma::load_matrix_sync(b, wbuf + k * ldw3 + oc * 16, ldw3);
#pragma unroll
      for (int i = 0; i < TH; ++i) {
        FragA a;
        wmma::load_matrix_sync(a, y2s + i * 16 * ldy + k, ldy);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
    const int col = oc * 16 + ec;
#pragma unroll
    for (int i = 0; i < TH; ++i) {
      wmma::store_matrix_sync(wstage, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      float y3[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) y3[j] = round_bf16(wstage[er * 16 + ec + j] + b3[col + j]);
      __syncwarp();
      // the 16 output pixels of row i sit at the halo's centre
      const bf16* xrow = xs + ((i + 1) * HALO_W + 1) * ldx;
      float res[8];
      if (has_down) {
        FragC accd;
        wmma::fill_fragment(accd, 0.0f);
        for (int k = 0; k < C; k += 16) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, xrow + k, ldx);
          wmma::load_matrix_sync(b, wd + (size_t)k * O + oc * 16, O);
          wmma::mma_sync(accd, a, b, accd);
        }
        wmma::store_matrix_sync(wstage, accd, 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 8; ++j) res[j] = round_bf16(wstage[er * 16 + ec + j] + bd[col + j]);
        __syncwarp();
      } else {
        unpack8(*reinterpret_cast<const uint4*>(xrow + er * ldx + col), res);
      }
      const int gy = ty0 + i;
      const int gx = tx0 + er;
      if (gy < H && gx < W) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = fmaxf(y3[j] + res[j], 0.0f);
        *reinterpret_cast<uint4*>(outn + ((size_t)gy * W + gx) * O + col) = pack8(v);
      }
    }
  }
}

int wbuf_elems(int C, int M, int O) {
  int e = C * (M + SKEW);
  if (3 * M * (M + SKEW) > e) e = 3 * M * (M + SKEW);
  if (M * (O + SKEW) > e) e = M * (O + SKEW);
  return e;
}

template <int M>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* wd,
           const void* bd, void* out, int B, int H, int W, int C, int O,
           int has_down, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fused_bottleneck_kernel<M><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)wd,
      (const float*)bd, (bf16*)out, H, W, C, O, has_down, wbuf_elems(C, M, O));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_bottleneck_smem_bytes(int C, int M, int O) {
  return (HALO_PAD * (C + SKEW) + HALO_PAD * (M + SKEW) + TH * TW * (M + SKEW) +
          wbuf_elems(C, M, O)) * 2 + WARPS * 256 * 4;
}

extern "C" int fused_bottleneck_bf16(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* w3,
                                     const void* b3, const void* wd, const void* bd,
                                     void* out, int B, int H, int W, int C, int M,
                                     int O, int has_down, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % 16 ||
      O % 16 || (M != 16 && M != 32 && M != 64 && M != 128) ||
      (!has_down && O != C))
    return (int)cudaErrorInvalidValue;
  const int smem = fused_bottleneck_smem_bytes(C, M, O);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  switch (M) {
    case 16:
      return launch<16>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                        has_down, smem, stream);
    case 32:
      return launch<32>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                        has_down, smem, stream);
    case 64:
      return launch<64>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                        has_down, smem, stream);
    default:
      return launch<128>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                         has_down, smem, stream);
  }
}

extern "C" const char* fused_bottleneck_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
