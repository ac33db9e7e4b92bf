// Fused stride-1 ResNet bottleneck at int8 static-scale inference, bf16 in and
// out, for Hopper (sm_90a). Kernel K3.
//
// Replaces dir_tpu/ops/pallas_bottleneck.py:_quant_kernel (reached by
// fused_bottleneck_int8_infer). With BN folded into the weights and the
// weights quantized per output channel beforehand, it computes
//   xq  = q(x, inv[0])                         q(v, i) = clip(rint(v * i), +-127)
//   y1  = relu(bf16(s32(xq . w1q) * m1 + b1))  zero in the 3x3 halo outside the image
//   y2  = relu(bf16(s32(conv3x3(q(y1, inv[1]), w2q)) * m2 + b2))
//   y3  = bf16(s32(q(y2, inv[2]) . w3q) * m3 + b3)
//   res = x, or bf16(s32(xq . wdq) * md + bd) for the projection form
//   out = relu(bf16(y3 + res))
// The s8 x s8 -> s32 sums are exact; each dequantize is one fp32 product and
// one fp32 sum, rounded separately (no FMA), as in the plain PyTorch version,
// so both walk the same int8 grid. rint and the bf16 casts round half to even.
//
// What bounds it on an H100: the block input and output, as for the bf16
// kernels. At (B, 64, 64, 256), mid 64: B*4096*(256+256)*2 bytes (1.07 GB at
// B = 256, 0.32 ms at 3.35 TB/s) against 146 G int8 operations (0.074 ms at
// 1,979 TOP/s); at (B, 32, 32, 512), mid 128: 537 MB, 0.16 ms. Bytes.
//
// What the design does about it: x is quantized once while its halo is loaded,
// and neither its int8 copy nor the bf16 and int8 copies of y1 and y2 leave
// shared memory. The tiling is the bf16 kernels': a block of 16 warps owns an
// 8x16 tile of output pixels of one sample and its 10x18 halo, so every 3x3
// tap of one output row is 16 consecutive halo rows. Int8 halves the halo, so
// the layer2 shape (C 512, mid 128) fits whole in 216 KB where the bf16
// kernel has to stream it: the halo of xq, y1q, y2q and one phase's weights
// (w1, then w2 one kernel row at a time, then w3). The TPU kernel's row bands
// are a schedule of its own and are not carried over. The products are
// mma.sync m16n8k32 s8 fragments loaded from shared memory with ldmatrix (rows
// padded by 16 bytes: the eight rows of a matrix fall into eight different
// 16-byte bank groups). The wrapper hands each weight over transposed, (N, K),
// with the rows of every 32 output channels ordered so that a thread's eight
// accumulator values of four 16x8 fragments are eight consecutive channels:
// every epilogue reads its scales and writes its result as whole vectors. The
// identity residual is read from device memory in the epilogue (the halo load
// just read it); the projection reads its weight fragments from device
// memory. wgmma, TMA and overlap of loads with math are left for later work.
//
// C interface (bound with ctypes): fused_bottleneck_int8_bf16 launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;                     // output rows per block
constexpr int TW = 16;                    // output columns per block: one 16-row fragment
constexpr int HALO_W = TW + 2;            // 18
constexpr int HALO = (TH + 2) * HALO_W;   // 180 halo pixels
constexpr int HALO_TILES = 12;            // 16-row tiles covering the halo
constexpr int HALO_PAD = HALO_TILES * 16; // 192
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int SKEW = 16;                  // row padding in bytes
constexpr int MAX_SMEM = 232448;          // H100: 227 KB of dynamic shared memory per block

// D += A (16x32 s8, row-major) . B (32x8 s8, column-major), s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8-row x 16-byte matrices from shared memory, one row address a lane
// (lanes 8i..8i+7 give matrix i); register i holds, of matrix i, row lane/4,
// bytes (lane%4)*4..+3: the layout of the s8 mma's A and B registers.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment (16 rows x 32 bytes at byte k0 of the shared rows from base):
// matrices (rows 0-7, k0), (rows 8-15, k0), (rows 0-7, k0+16), (rows 8-15,
// k0+16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* base, int ld,
                                       int k0, int lane) {
  ldmatrix_x4(a, base + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 + (lane >> 4) * 16);
}

// The B fragments of two neighbouring 8-channel tiles from an (N, K) weight
// in shared memory (rows from base): b[0], b[1] the first tile's, b[2], b[3]
// the second's.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const int8_t* base, int ld,
                                        int k0, int lane) {
  ldmatrix_x4(b, base + ((lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 16);
}

// One B fragment from an (N, K) weight in device memory: row lane/4, bytes
// k0 + (lane%4)*4 and + 16.
__device__ __forceinline__ void load_b_global(uint32_t (&b)[2], const int8_t* base,
                                              size_t ld, int k0, int g, int tig) {
  const int8_t* p = base + g * ld + k0 + tig * 4;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

// acc[0..3] += a . the four 8-channel tiles of the 32 weight rows from base.
__device__ __forceinline__ void mma_32cols(int (&acc)[4][4], const uint32_t (&a)[4],
                                           const int8_t* base, int ld, int k0, int lane) {
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    uint32_t b[4];
    load_b2(b, base + jp * 16 * ld, ld, k0, lane);
    const uint32_t b_lo[2] = {b[0], b[1]};
    const uint32_t b_hi[2] = {b[2], b[3]};
    mma_s8(acc[2 * jp], a, b_lo);
    mma_s8(acc[2 * jp + 1], a, b_hi);
  }
}

__device__ __forceinline__ int quantize(float v, float inv) {
  return max(-127, min(127, __float2int_rn(__fmul_rn(v, inv))));
}

// s32 -> fp32, times m, plus b (two roundings), rounded to bf16.
__device__ __forceinline__ float dequant_bf16(int acc, float m, float b) {
  return __bfloat162float(
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc), m), b)));
}

__device__ __forceinline__ uint32_t pack4(const int* q) {
  return (uint32_t)(q[0] & 0xff) | ((uint32_t)(q[1] & 0xff) << 8) |
         ((uint32_t)(q[2] & 0xff) << 16) | ((uint32_t)(q[3] & 0xff) << 24);
}

__device__ __forceinline__ uint4 pack8_bf16(const float* v) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<unsigned*>(&t);
  }
  return u;
}

__device__ __forceinline__ void unpack8_bf16(uint4 u, float* v) {
  const __nv_bfloat162* t = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(t[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// rows x cols bytes (row-major, cols a multiple of 16) from device memory into
// shared memory rows of stride ldd, 16 bytes per thread and step.
__device__ __forceinline__ void stage_rows(int8_t* dst, int ldd, const int8_t* src,
                                           int rows, int cols) {
  const int cv = cols / 16;
  for (int i = threadIdx.x; i < rows * cv; i += THREADS) {
    const int r = i / cv;
    const int v = i - r * cv;
    *reinterpret_cast<uint4*>(dst + r * ldd + v * 16) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * cols + v * 16);
  }
}

// The eight accumulator values a thread holds for row half hf (row lane/4 or
// that + 8) of four 16x8 fragments, in channel order.
__device__ __forceinline__ void row_values(const int (&acc)[4][4], int hf, int* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = acc[j][hf * 2];
    v[2 * j + 1] = acc[j][hf * 2 + 1];
  }
}

__device__ __forceinline__ void zero(int (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
}

// M (mid) is a template parameter: the count of conv2 accumulators a warp
// keeps across the kernel rows follows from it at compile time.
template <int M>
__global__ void __launch_bounds__(THREADS, 1)
fused_bottleneck_int8_kernel(const bf16* __restrict__ x, const float* __restrict__ inv,
                             const int8_t* __restrict__ w1, const float* __restrict__ m1,
                             const float* __restrict__ b1,
                             const int8_t* __restrict__ w2, const float* __restrict__ m2,
                             const float* __restrict__ b2,
                             const int8_t* __restrict__ w3, const float* __restrict__ m3,
                             const float* __restrict__ b3,
                             const int8_t* __restrict__ wd, const float* __restrict__ md,
                             const float* __restrict__ bd,
                             bf16* __restrict__ out, int H, int W, int C, int O,
                             int has_down) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldx = C + SKEW;
  constexpr int ldy = M + SKEW;
  int8_t* xs = reinterpret_cast<int8_t*>(smem_raw);       // (HALO_PAD, ldx) xq halo
  int8_t* y1s = xs + HALO_PAD * ldx;                      // (HALO_PAD, ldy) y1q halo
  int8_t* y2s = y1s + HALO_PAD * ldy;                     // (TH * TW, ldy) y2q
  int8_t* wbuf = y2s + TH * TW * ldy;                     // the phase's weights

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * TH;
  const size_t n = blockIdx.z;
  const bf16* xn = x + n * H * W * C;
  const float inv_in = inv[0];
  const float inv1 = inv[1];
  const float inv2 = inv[2];

  // Phase 0: the halo of x, quantized on the way in (zero outside the image
  // and in the padding rows), and w1 into shared memory.
  const int cv = C / 8;
  for (int i = threadIdx.x; i < HALO_PAD * cv; i += THREADS) {
    const int r = i / cv;
    const int v = i - r * cv;
    const int gy = ty0 - 1 + r / HALO_W;
    const int gx = tx0 - 1 + r % HALO_W;
    uint2 q2 = make_uint2(0u, 0u);
    if (r < HALO && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      float f[8];
      unpack8_bf16(*reinterpret_cast<const uint4*>(xn + ((size_t)gy * W + gx) * C + v * 8), f);
      int q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = quantize(f[j], inv_in);
      q2 = make_uint2(pack4(q), pack4(q + 4));
    }
    *reinterpret_cast<uint2*>(xs + r * ldx + v * 8) = q2;
  }
  stage_rows(wbuf, ldx, w1, M, C);
  __syncthreads();

  constexpr int NG = M / 32;   // groups of 32 mid channels

  // Phase 1: y1q over the whole halo. A halo pixel outside the image is
  // conv2's zero padding of the quantized map: it is 0, not q(relu(b1)).
  for (int unit = warp; unit < HALO_TILES * NG; unit += WARPS) {
    const int mt = unit / NG;
    const int ng = unit - mt * NG;
    int acc[4][4];
    zero(acc);
    for (int k0 = 0; k0 < C; k0 += 32) {
      uint32_t a[4];
      load_a(a, xs + mt * 16 * ldx, ldx, k0, lane);
      mma_32cols(acc, a, wbuf + ng * 32 * ldx, ldx, k0, lane);
    }
    const int cb = ng * 32 + tig * 8;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + g + hf * 8;
      const int gy = ty0 - 1 + r / HALO_W;
      const int gx = tx0 - 1 + r % HALO_W;
      const bool inside = r < HALO && gy >= 0 && gy < H && gx >= 0 && gx < W;
      int v[8], q[8];
      row_values(acc, hf, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float y = fmaxf(dequant_bf16(v[j], m1[cb + j], b1[cb + j]), 0.0f);
        q[j] = inside ? quantize(y, inv1) : 0;
      }
      *reinterpret_cast<uint2*>(y1s + r * ldy + cb) = make_uint2(pack4(q), pack4(q + 4));
    }
  }
  __syncthreads();

  // Phase 2: y2q, one kernel row (3 taps) of w2 in shared memory at a time.
  // Output row oy, tap (dy, dx) reads the 16 consecutive halo rows starting
  // at (oy + dy) * HALO_W + dx.
  {
    constexpr int UNITS = TH * NG;
    constexpr int PER_WARP = (UNITS + WARPS - 1) / WARPS;
    int acc[PER_WARP][4][4];
#pragma unroll
    for (int u = 0; u < PER_WARP; ++u) zero(acc[u]);
    for (int dy = 0; dy < 3; ++dy) {
      stage_rows(wbuf, ldy, w2 + (size_t)dy * 3 * M * M, 3 * M, M);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < PER_WARP; ++u) {
        const int unit = warp + u * WARPS;
        if (unit < UNITS) {
          const int oy = unit % TH;
          const int ng = unit / TH;
          for (int dx = 0; dx < 3; ++dx) {
            for (int k0 = 0; k0 < M; k0 += 32) {
              uint32_t a[4];
              load_a(a, y1s + ((oy + dy) * HALO_W + dx) * ldy, ldy, k0, lane);
              mma_32cols(acc[u], a, wbuf + (dx * M + ng * 32) * ldy, ldy, k0, lane);
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < PER_WARP; ++u) {
      const int unit = warp + u * WARPS;
      if (unit < UNITS) {
        const int oy = unit % TH;
        const int cb = (unit / TH) * 32 + tig * 8;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int v[8], q[8];
          row_values(acc[u], hf, v);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            q[j] = quantize(fmaxf(dequant_bf16(v[j], m2[cb + j], b2[cb + j]), 0.0f), inv2);
          *reinterpret_cast<uint2*>(y2s + (oy * 16 + g + hf * 8) * ldy + cb) =
              make_uint2(pack4(q), pack4(q + 4));
        }
      }
    }
  }
  stage_rows(wbuf, ldy, w3, O, M);
  __syncthreads();

  // Phase 3: y3 and the residual, each rounded to bf16, then their bf16 sum
  // through relu to device memory, 16 bytes per thread and row.
  bf16* outn = out + n * H * W * O;
  for (int unit = warp; unit < TH * (O / 32); unit += WARPS) {
    const int oy = unit % TH;
    const int og = unit / TH;
    int acc[4][4];
    zero(acc);
    for (int k0 = 0; k0 < M; k0 += 32) {
      uint32_t a[4];
      load_a(a, y2s + oy * 16 * ldy, ldy, k0, lane);
      mma_32cols(acc, a, wbuf + og * 32 * ldy, ldy, k0, lane);
    }
    int accd[4][4];
    if (has_down) {
      zero(accd);
      // the 16 output pixels of row oy sit at the halo's centre
      const int8_t* xrow = xs + ((oy + 1) * HALO_W + 1) * ldx;
      for (int k0 = 0; k0 < C; k0 += 32) {
        uint32_t a[4];
        load_a(a, xrow, ldx, k0, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[2];
          load_b_global(b, wd + (size_t)(og * 32 + j * 8) * C, (size_t)C, k0, g, tig);
          mma_s8(accd[j], a, b);
        }
      }
    }
    const int cb = og * 32 + tig * 8;
    const int gy = ty0 + oy;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gx = tx0 + g + hf * 8;
      if (gy < H && gx < W) {
        int v[8];
        float res[8], o8[8];
        if (has_down) {
          row_values(accd, hf, v);
#pragma unroll
          for (int j = 0; j < 8; ++j) res[j] = dequant_bf16(v[j], md[cb + j], bd[cb + j]);
        } else {
          unpack8_bf16(*reinterpret_cast<const uint4*>(xn + ((size_t)gy * W + gx) * C + cb), res);
        }
        row_values(acc, hf, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y3 = dequant_bf16(v[j], m3[cb + j], b3[cb + j]);
          // the add runs in bf16: round the sum, then relu
          o8[j] = fmaxf(__bfloat162float(__float2bfloat16_rn(__fadd_rn(y3, res[j]))), 0.0f);
        }
        *reinterpret_cast<uint4*>(outn + ((size_t)gy * W + gx) * O + cb) = pack8_bf16(o8);
      }
    }
  }
}

int wbuf_bytes(int C, int M, int O) {
  int e = M * (C + SKEW);
  if (3 * M * (M + SKEW) > e) e = 3 * M * (M + SKEW);
  if (O * (M + SKEW) > e) e = O * (M + SKEW);
  return e;
}

template <int M>
int launch(const void* x, const void* inv, const void* w1, const void* m1, const void* b1,
           const void* w2, const void* m2, const void* b2, const void* w3, const void* m3,
           const void* b3, const void* wd, const void* md, const void* bd, void* out,
           int B, int H, int W, int C, int O, int has_down, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_int8_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fused_bottleneck_int8_kernel<M><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)inv, (const int8_t*)w1, (const float*)m1,
      (const float*)b1, (const int8_t*)w2, (const float*)m2, (const float*)b2,
      (const int8_t*)w3, (const float*)m3, (const float*)b3, (const int8_t*)wd,
      (const float*)md, (const float*)bd, (bf16*)out, H, W, C, O, has_down);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_bottleneck_int8_smem_bytes(int C, int M, int O) {
  return HALO_PAD * (C + SKEW) + HALO_PAD * (M + SKEW) + TH * TW * (M + SKEW) +
         wbuf_bytes(C, M, O);
}

// x (B, H, W, C) bf16; inv (3,) fp32; w1 (M, C), w2 (9, M, M), w3 (O, M) and
// wd (O, C) int8, output channel major, each group of 32 output channels in
// the fragment order (ops/fused_bottleneck_int8.py:_kernel_order); m* and b*
// fp32 per output channel in channel order.
extern "C" int fused_bottleneck_int8_bf16(
    const void* x, const void* inv, const void* w1, const void* m1, const void* b1,
    const void* w2, const void* m2, const void* b2, const void* w3, const void* m3,
    const void* b3, const void* wd, const void* md, const void* bd, void* out,
    int B, int H, int W, int C, int M, int O, int has_down, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % 32 ||
      O % 32 || (M != 32 && M != 64 && M != 128) || (!has_down && O != C))
    return (int)cudaErrorInvalidValue;
  const int smem = fused_bottleneck_int8_smem_bytes(C, M, O);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  switch (M) {
    case 32:
      return launch<32>(x, inv, w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md, bd, out,
                        B, H, W, C, O, has_down, smem, stream);
    case 64:
      return launch<64>(x, inv, w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md, bd, out,
                        B, H, W, C, O, has_down, smem, stream);
    default:
      return launch<128>(x, inv, w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md, bd, out,
                         B, H, W, C, O, has_down, smem, stream);
  }
}

extern "C" const char* fused_bottleneck_int8_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
