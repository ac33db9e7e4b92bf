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
// another's math are left for later work. That kernel (K1) is
// fused_bottleneck_kernel<M, false> of bottleneck_tile.cuh, which also holds
// the stem form K4 (fused_stem_bottleneck.cu).
//
// A second kernel (K2, fused_bottleneck_streamed_kernel) computes the same
// function where K1's working set does not fit: at the layer2 shape
// (B, 32, 32, 512), mid 128, K1 would need 459 KB of the 227 KB a block may
// use. It replaces the row-banded Pallas `_kernel_banded` that the same call
// reaches with bands=N; its note stands above it.
//
// C interface (bound with ctypes): fused_bottleneck_bf16 (K1) and
// fused_bottleneck_streamed_bf16 (K2) launch on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError() (or
// cudaErrorInvalidValue for shapes they do not take).

#include "bottleneck_tile.cuh"

namespace {

// K1 is fused_bottleneck_kernel<M, false> of bottleneck_tile.cuh.
template <int M>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* wd,
           const void* bd, void* out, int B, int H, int W, int C, int O,
           int has_down, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_kernel<M, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fused_bottleneck_kernel<M, false><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, nullptr, nullptr, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)wd,
      (const float*)bd, (bf16*)out, H, W, C, O, has_down, wbuf_elems(C, M, O));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2: the same block with every operand streamed through shared memory.
//
// Replaces dir_tpu/ops/pallas_bottleneck.py:_kernel_banded (reached by
// fused_bottleneck_infer(bands=N)). The TPU kernel bands rows because one
// sample's 3x3 window concat overflows its fast memory; here a block already
// owns only an 8x16 tile, and what does not fit at the layer2 shape is K1's
// habit of holding the tile's x halo at all C channels (203 KB at C = 512)
// and a whole phase's weights. So the tiling stays K1's and the bands are not
// carried over; instead
//   conv1 streams its K dimension: the x halo and w1 arrive in chunks of 64
//     channels, double-buffered with cp.async, and y1's accumulators stay in
//     registers across the chunks (6 fragments a warp at mid 128);
//   conv2 and conv3 stream their weights as (mid, mid) tiles, one 3x3 tap or
//     one block of mid output channels at a time, through the same two
//     buffers, so the next tile loads while the tensor cores work on this one;
//   the identity residual is read from device memory in the epilogue (the
//     halo load just read it, so it is mostly in L2); a projected residual
//     streams the tile's own pixels of x through a third buffer.
// The rounding points are K1's, and the plain version's. Shared memory depends
// on mid only (222 KB at mid 128), so any C and O that are multiples of 16 are
// taken.
//
// What bounds it on an H100: at (B, 32, 32, 512), mid 128, input and output
// are B*1024*(512+512)*2 bytes (537 MB at B = 256, 0.160 ms at 3.35 TB/s)
// against 2*B*1024*(512*128 + 9*128*128 + 128*512) = 146 GFLOP (0.148 ms at
// 989 TFLOP/s): bytes, narrowly. The halo re-read (1.4x the input pixels) and
// conv1 on the halo (1.5x its products) are the price of keeping y1 and y2
// out of device memory, as in K1.

constexpr int KC = 64;              // channels of x per conv1 chunk
constexpr int LDXC = KC + SKEW;     // row stride of a staged x chunk

// Elements of one streaming buffer: a conv1 chunk (x halo + w1 rows) or one
// (mid, mid) weight tile, whichever is larger.
__host__ __device__ constexpr int slot_elems(int M) {
  return HALO_PAD * LDXC + KC * (M + SKEW) > M * (M + SKEW)
             ? HALO_PAD * LDXC + KC * (M + SKEW)
             : M * (M + SKEW);
}

// rows x cols bf16 (cols a multiple of 8) of a row-major matrix with row
// stride lds into shared rows of stride ldd, as asynchronous 16-byte copies.
__device__ __forceinline__ void stage_tile_async(bf16* dst, int ldd, const bf16* src,
                                                 int lds, int rows, int cols) {
  const int cv = cols / 8;
  for (int i = threadIdx.x; i < rows * cv; i += THREADS) {
    const int r = i / cv;
    const int v = i - r * cv;
    __pipeline_memcpy_async(dst + r * ldd + v * 8, src + (size_t)r * lds + v * 8, 16);
  }
}

// Channels [k0, k0 + kw) of the tile's x halo and the matching rows of w1 into
// one buffer, asynchronously; halo pixels outside the image and the padding
// rows are zero. One commit group.
template <int M>
__device__ __forceinline__ void start_conv1_chunk(bf16* slot, const bf16* xn,
                                                  const bf16* w1, int H, int W, int C,
                                                  int ty0, int tx0, int k0, int kw) {
  const int cv = kw / 8;
  for (int i = threadIdx.x; i < HALO_PAD * cv; i += THREADS) {
    const int r = i / cv;
    const int v = i - r * cv;
    const int gy = ty0 - 1 + r / HALO_W;
    const int gx = tx0 - 1 + r % HALO_W;
    bf16* d = slot + r * LDXC + v * 8;
    if (r < HALO && gy >= 0 && gy < H && gx >= 0 && gx < W)
      __pipeline_memcpy_async(d, xn + ((size_t)gy * W + gx) * C + k0 + v * 8, 16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  stage_tile_async(slot + HALO_PAD * LDXC, M + SKEW, w1 + (size_t)k0 * M, M, kw, M);
  __pipeline_commit();
}

// Weight tile t of the conv2/conv3 stream into one buffer: t < 9 is the 3x3
// tap t of w2, t >= 9 the output channels [(t-9)*M, (t-8)*M) of w3. One commit
// group.
template <int M>
__device__ __forceinline__ void start_weight_tile(bf16* slot, const bf16* w2,
                                                  const bf16* w3, int O, int t) {
  if (t < 9) {
    stage_tile_async(slot, M + SKEW, w2 + (size_t)t * M * M, M, M, M);
  } else {
    const int o0 = (t - 9) * M;
    stage_tile_async(slot, M + SKEW, w3 + o0, O, M, min(M, O - o0));
  }
  __pipeline_commit();
}

template <int M>
__global__ void __launch_bounds__(THREADS, 1)
fused_bottleneck_streamed_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ w1, const float* __restrict__ b1,
                                 const bf16* __restrict__ w2, const float* __restrict__ b2,
                                 const bf16* __restrict__ w3, const float* __restrict__ b3,
                                 const bf16* __restrict__ wd, const float* __restrict__ bd,
                                 bf16* __restrict__ out, int H, int W, int C, int O,
                                 int has_down) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int ldy = M + SKEW;
  constexpr int SLOT = slot_elems(M);
  bf16* y1s = reinterpret_cast<bf16*>(smem_raw);          // (HALO_PAD, ldy) y1 halo
  bf16* y2s = y1s + HALO_PAD * ldy;                       // (TH * TW, ldy) y2
  bf16* slots = y2s + TH * TW * ldy;                      // two streaming buffers
  bf16* xc = slots + 2 * SLOT;                            // (TH * TW, LDXC) x chunk, projection
  float* stage = reinterpret_cast<float*>(xc + TH * TW * LDXC);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wstage = stage + warp * 256;                     // one 16x16 fp32 tile per warp
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const size_t n = blockIdx.z;
  const bf16* xn = x + n * H * W * C;

  // Warp -> (column tile, row group), for all three convs: a weight tile is
  // mid columns wide in each of them.
  constexpr int mt = M / 16;
  constexpr int rgroups = WARPS / mt;
  constexpr int ACC1 = (HALO_TILES + rgroups - 1) / rgroups;
  constexpr int ACC2 = (TH + rgroups - 1) / rgroups;
  const int ct = warp % mt;
  const int g = warp / mt;

  // Phase 1: y1 = relu(x . w1 + b1) over the halo, K streamed in chunks.
  {
    FragC acc[ACC1];
#pragma unroll
    for (int i = 0; i < ACC1; ++i) wmma::fill_fragment(acc[i], 0.0f);
    const int nk = (C + KC - 1) / KC;
    start_conv1_chunk<M>(slots, xn, w1, H, W, C, ty0, tx0, 0, min(KC, C));
    for (int kc = 0; kc < nk; ++kc) {
      const bf16* xs = slots + (kc & 1) * SLOT;
      if (kc + 1 < nk) {
        const int k0 = (kc + 1) * KC;
        start_conv1_chunk<M>(slots + ((kc + 1) & 1) * SLOT, xn, w1, H, W, C, ty0, tx0,
                             k0, min(KC, C - k0));
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const bf16* ws = xs + HALO_PAD * LDXC;
      const int kw = min(KC, C - kc * KC);
      for (int k = 0; k < kw; k += 16) {
        FragB b;
        wmma::load_matrix_sync(b, ws + k * ldy + ct * 16, ldy);
#pragma unroll
        for (int i = 0; i < ACC1; ++i) {
          const int rt = g + i * rgroups;
          if (rt < HALO_TILES) {
            FragA a;
            wmma::load_matrix_sync(a, xs + rt * 16 * LDXC + k, LDXC);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
      __syncthreads();   // this buffer is refilled by the next iteration's copies
    }
    // both buffers are free: the first 3x3 tap loads behind the epilogue
    start_weight_tile<M>(slots, w2, w3, O, 0);
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
        // a halo pixel outside the image is conv2's zero padding
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

  // Phase 2: y2 = relu(conv3x3(y1) + b2), one tap's weights at a time. The
  // tile after the ninth tap is the first of w3, so it is always there to
  // prefetch. The first iteration's barrier also publishes y1s.
  const int n3 = (O + M - 1) / M;
  {
    FragC acc[ACC2];
#pragma unroll
    for (int i = 0; i < ACC2; ++i) wmma::fill_fragment(acc[i], 0.0f);
    for (int t = 0; t < 9; ++t) {
      const bf16* ws = slots + (t & 1) * SLOT;
      start_weight_tile<M>(slots + ((t + 1) & 1) * SLOT, w2, w3, O, t + 1);
      __pipeline_wait_prior(1);
      __syncthreads();
      const int dy = t / 3;
      const int dx = t - dy * 3;
      for (int k = 0; k < M; k += 16) {
        FragB b;
        wmma::load_matrix_sync(b, ws + k * ldy + ct * 16, ldy);
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

  // Phase 3: per block of mid output channels, y3 = y2 . w3 + b3 and the
  // residual, each rounded to bf16, then their bf16 sum through relu to
  // device memory, 16 bytes per lane.
  bf16* outn = out + n * H * W * O;
  for (int j3 = 0; j3 < n3; ++j3) {
    const int t = 9 + j3;
    const bf16* ws = slots + (t & 1) * SLOT;
    if (j3 + 1 < n3) {
      start_weight_tile<M>(slots + ((t + 1) & 1) * SLOT, w2, w3, O, t + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();   // for j3 = 0 this also publishes y2s
    const int o0 = j3 * M;
    const bool active = ct * 16 < min(M, O - o0);   // the last block may be narrower
    const int col = o0 + ct * 16 + ec;

    float y3[ACC2][8];
    if (active) {
      FragC acc[ACC2];
#pragma unroll
      for (int i = 0; i < ACC2; ++i) wmma::fill_fragment(acc[i], 0.0f);
      for (int k = 0; k < M; k += 16) {
        FragB b;
        wmma::load_matrix_sync(b, ws + k * ldy + ct * 16, ldy);
#pragma unroll
        for (int i = 0; i < ACC2; ++i) {
          const int oy = g + i * rgroups;
          if (oy < TH) {
            FragA a;
            wmma::load_matrix_sync(a, y2s + oy * 16 * ldy + k, ldy);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < ACC2; ++i) {
        if (g + i * rgroups < TH) {
          wmma::store_matrix_sync(wstage, acc[i], 16, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int j = 0; j < 8; ++j)
            y3[i][j] = round_bf16(wstage[er * 16 + ec + j] + b3[col + j]);
          __syncwarp();
        }
      }
    }

    // the projected residual: x . wd over the tile's own pixels, K streamed
    // through xc; wd's fragments come from device memory
    FragC accd[ACC2];
    if (has_down) {
#pragma unroll
      for (int i = 0; i < ACC2; ++i) wmma::fill_fragment(accd[i], 0.0f);
      for (int k0 = 0; k0 < C; k0 += KC) {
        const int kw = min(KC, C - k0);
        const int cv = kw / 8;
        __syncthreads();   // the previous chunk's readers are done
        for (int i = threadIdx.x; i < TH * TW * cv; i += THREADS) {
          const int r = i / cv;
          const int v = i - r * cv;
          const int gy = ty0 + r / TW;
          const int gx = tx0 + r % TW;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (gy < H && gx < W)
            val = *reinterpret_cast<const uint4*>(xn + ((size_t)gy * W + gx) * C + k0 + v * 8);
          *reinterpret_cast<uint4*>(xc + r * LDXC + v * 8) = val;
        }
        __syncthreads();
        if (active) {
          for (int k = 0; k < kw; k += 16) {
            FragB b;
            wmma::load_matrix_sync(b, wd + (size_t)(k0 + k) * O + o0 + ct * 16, O);
#pragma unroll
            for (int i = 0; i < ACC2; ++i) {
              const int oy = g + i * rgroups;
              if (oy < TH) {
                FragA a;
                wmma::load_matrix_sync(a, xc + oy * 16 * LDXC + k, LDXC);
                wmma::mma_sync(accd[i], a, b, accd[i]);
              }
            }
          }
        }
      }
    }

    if (active) {
#pragma unroll
      for (int i = 0; i < ACC2; ++i) {
        const int oy = g + i * rgroups;
        if (oy < TH) {
          const int gy = ty0 + oy;
          const int gx = tx0 + er;
          const bool inside = gy < H && gx < W;
          float res[8];
          if (has_down) {
            wmma::store_matrix_sync(wstage, accd[i], 16, wmma::mem_row_major);
            __syncwarp();
#pragma unroll
            for (int j = 0; j < 8; ++j)
              res[j] = round_bf16(wstage[er * 16 + ec + j] + bd[col + j]);
            __syncwarp();
          } else if (inside) {
            unpack8(*reinterpret_cast<const uint4*>(xn + ((size_t)gy * W + gx) * C + col), res);
          }
          if (inside) {
            float v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = fmaxf(y3[i][j] + res[j], 0.0f);
            *reinterpret_cast<uint4*>(outn + ((size_t)gy * W + gx) * O + col) = pack8(v);
          }
        }
      }
    }
    __syncthreads();   // this w3 buffer is refilled by the next iteration's copies
  }
}

template <int M>
int launch_streamed(const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* w3, const void* b3, const void* wd,
                    const void* bd, void* out, int B, int H, int W, int C, int O,
                    int has_down, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_streamed_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fused_bottleneck_streamed_kernel<M><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)wd,
      (const float*)bd, (bf16*)out, H, W, C, O, has_down);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_bottleneck_smem_bytes(int C, int M, int O) {
  return tile_smem_bytes(C, M, O);
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

extern "C" int fused_bottleneck_streamed_smem_bytes(int M) {
  return (HALO_PAD * (M + SKEW) + TH * TW * (M + SKEW) + 2 * slot_elems(M) +
          TH * TW * LDXC) * 2 + WARPS * 256 * 4;
}

extern "C" int fused_bottleneck_streamed_bf16(const void* x, const void* w1, const void* b1,
                                              const void* w2, const void* b2, const void* w3,
                                              const void* b3, const void* wd, const void* bd,
                                              void* out, int B, int H, int W, int C, int M,
                                              int O, int has_down, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % 16 ||
      O % 16 || (M != 16 && M != 32 && M != 64 && M != 128) ||
      (!has_down && O != C))
    return (int)cudaErrorInvalidValue;
  const int smem = fused_bottleneck_streamed_smem_bytes(M);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  switch (M) {
    case 16:
      return launch_streamed<16>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                                 has_down, smem, stream);
    case 32:
      return launch_streamed<32>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                                 has_down, smem, stream);
    case 64:
      return launch_streamed<64>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                                 has_down, smem, stream);
    default:
      return launch_streamed<128>(x, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                                  has_down, smem, stream);
  }
}

extern "C" const char* fused_bottleneck_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
