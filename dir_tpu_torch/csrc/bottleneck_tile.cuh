// The whole-halo WMMA tile kernel of K4 (fused_stem_bottleneck.cu): its tiling
// constants, bf16 packing helpers and fused_stem_bottleneck_kernel.

#pragma once

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

// The fused block on one 8x16 output tile, fed by the raw stem-conv output x
// (B, 2H, 2W, C): the halo is its BN affine g1, t1, ReLU and 3x3 stride-2 max
// pool, and the residual is the projection. M (mid) is a template parameter:
// each warp's count of accumulators follows from it at compile time.
template <int M>
__global__ void __launch_bounds__(THREADS, 1)
fused_stem_bottleneck_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ g1, const float* __restrict__ t1,
                        const bf16* __restrict__ w1, const float* __restrict__ b1,
                        const bf16* __restrict__ w2, const float* __restrict__ b2,
                        const bf16* __restrict__ w3, const float* __restrict__ b3,
                        const bf16* __restrict__ wd, const float* __restrict__ bd,
                        bf16* __restrict__ out, int H, int W, int C, int O,
                        int has_down, int wbuf_len) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = C + SKEW;
  const int ldy = M + SKEW;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);          // (HALO_PAD, ldx) x halo
  bf16* y1s = xs + HALO_PAD * ldx;                        // (HALO_PAD, ldy) y1 halo
  bf16* y2s = y1s + HALO_PAD * ldy;                       // (TH * TW, ldy) y2
  bf16* wbuf = y2s + TH * TW * ldy;                       // the phase's weights
  float* stage = reinterpret_cast<float*>(wbuf + wbuf_len);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wstage = stage + warp * 256;                     // one 16x16 fp32 tile per warp
  // epilogue: lane owns 8 consecutive columns of one row of a 16x16 tile
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const size_t n = blockIdx.z;
  const bf16* xn = x + n * 4 * H * W * C;

  // Phase 0: the tile's pooled halo (zero outside the map and in the padding
  // rows) into shared memory, each pixel made from its nine raw pixels (H, W
  // are the pooled map's).
  const int cv = C / 8;
  for (int i = threadIdx.x; i < HALO_PAD * cv; i += THREADS) {
    const int r = i / cv;
    const int v = i - r * cv;
    const int gy = ty0 - 1 + r / HALO_W;
    const int gx = tx0 - 1 + r % HALO_W;
    const bool inside = r < HALO && gy >= 0 && gy < H && gx >= 0 && gx < W;
    float best[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) best[j] = 0.0f;   // the pool's zero padding
    if (inside) {
      float g[8], t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        g[j] = round_bf16(g1[v * 8 + j]);
        t[j] = round_bf16(t1[v * 8 + j]);
      }
      for (int dy = -1; dy <= 1; ++dy) {
        const int ry = 2 * gy + dy;
        if (ry < 0 || ry >= 2 * H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int rx = 2 * gx + dx;
          if (rx < 0 || rx >= 2 * W) continue;
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(
                      xn + ((size_t)ry * 2 * W + rx) * C + v * 8), f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // product and sum each rounded to bf16; relu is the 0 in best
            const float a = round_bf16(__fadd_rn(round_bf16(__fmul_rn(f[j], g[j])), t[j]));
            best[j] = fmaxf(best[j], a);
          }
        }
      }
    }
    const uint4 val = pack8(best);
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

// Elements of the kernel's weight buffer: the largest phase's weights.
inline int wbuf_elems(int C, int M, int O) {
  int e = C * (M + SKEW);
  if (3 * M * (M + SKEW) > e) e = 3 * M * (M + SKEW);
  if (M * (O + SKEW) > e) e = M * (O + SKEW);
  return e;
}

// Dynamic shared memory of one block of the kernel, in bytes.
inline int tile_smem_bytes(int C, int M, int O) {
  return (HALO_PAD * (C + SKEW) + HALO_PAD * (M + SKEW) + TH * TW * (M + SKEW) +
          wbuf_elems(C, M, O)) * 2 + WARPS * 256 * 4;
}

}  // namespace
