// Fused stride-1 ResNet bottleneck at inference, bf16 in and out, for Hopper
// (sm_90a): kernels K1 and K2, one template.
//
// Replaces dir_tpu/ops/pallas_bottleneck.py:_kernel (K1, reached by
// fused_bottleneck_infer with bands=0) and _kernel_banded (K2, bands>0). With
// BN folded into the weights beforehand both compute
//   y1  = bf16(relu(x . w1 + b1))            zero in the 3x3 halo outside the image
//   y2  = bf16(relu(conv3x3(y1, w2) + b2))
//   y3  = bf16(y2 . w3 + b3)
//   res = x, or bf16(x . wd + bd) for the projection form
//   out = bf16(relu(y3 + res))
// with bf16 operands and fp32 accumulation; biases are fp32. The TPU kernels'
// whole-map blocks and row bands serve its fast memory and are not carried
// over; K1 and K2 are two forms of one template here.
//
// What bounds them on an H100: the block input and output. At the layer1
// shape (B, 64, 64, 256), mid 64: B*4096*(256+256)*2 bytes (1.07 GB at
// B = 256, 0.32 ms at 3.35 TB/s) against 146 GFLOP (0.15 ms at 989 TFLOP/s).
// At the layer2 shape (B, 32, 32, 512), mid 128: 537 MB (0.160 ms) against
// 146 GFLOP (0.148 ms): bytes, narrowly.
//
// The design: y1 and y2 never leave the SM, and every product is a wgmma.
//   Tiles. A tile is 8x16 output pixels of one sample; conv1 runs over its
//     10x18 halo (three 64-row wgmma tiles, 192 rows, 1.5x the products of
//     its 128 pixels). The grid is persistent: one block an SM, each walking
//     the tiles (n, ty, tx) in a static stride.
//   Roles. Two consumer warpgroups do the math; one thread of a producer
//     warpgroup issues every copy (setmaxnreg gives the producer 56 registers
//     a thread and the consumers 224). Copies land in a ring of as many stages
//     as shared memory holds (2-6), each guarded by a full and an empty
//     mbarrier, so the next tile's first x chunks arrive while this tile runs
//     conv2, conv3 and its epilogue, and one chunk's conv1 products run while
//     the next chunk is awaited. Every wait is bounded: a pipeline fault traps
//     and the launch fails instead of hanging.
//   x's halo comes by TMA: a 4-D tensor map over NHWC x, a box of 64 channels
//     x 18 x 11 pixels (198 rows of 128 bytes, 128-byte swizzle), whose
//     zero fill outside the tensor gives the image border and C beyond the
//     last channel. The projection's x (the tile's own 128 pixels) is a
//     second box, 64 x 16 x 8, read again per conv3 chunk.
//   conv1: A is the x chunk, B the chunk's w1 rows, both through shared-memory
//     descriptors; each consumer warpgroup takes half of mid's columns over
//     all 192 rows, so both do the same work. y1 = relu(. + b1), masked, goes
//     to shared memory (rows padded by 16 bytes: ldmatrix without conflicts).
//   conv2: nine taps. A comes from registers, loaded by ldmatrix at per-lane
//     rows of y1 (a tap's shifted window is no descriptor's layout); B is the
//     tap's (mid, mid) tile. Each warp owns one output row of 16 pixels.
//   conv3: A is conv2's own accumulators, biased, ReLU'd and rounded to bf16
//     in registers: the accumulator layout of two 8-column tiles is the A
//     register layout of one k16 step, so y2 never touches shared memory. B
//     is w3, N3 = max(32, mid) output channels at a time. The wrapper orders
//     every 32 columns of w3 and wd so that a thread's eight values are eight
//     consecutive channels: the identity residual is read from L2 (a chunk
//     ahead of its use) and the output written as 16-byte vectors, with no
//     staging tile. (Staging each chunk in shared memory for a TMA store was
//     measured slower: one buffer, two barriers a chunk.)
//   Weights. The wrapper lays every weight out as the descriptors read it:
//     (N, K) K-major, 64-wide K panels, 128-byte swizzled, K zero-padded.
//     K1 (resident) loads w1, w2 and w3 once per block by bulk copy and keeps
//     them for its life; K2 (streamed) sends them through the ring per tile:
//     conv1 chunks carry their w1 panel, then the nine w2 taps, then the w3
//     chunks. The projection's wd always streams.
//   Shared memory, layer1 resident (C 256, mid 64, O 256): weights 136 KB,
//     2 halo stages of 25 KB, y1 27 KB, barriers and alignment 2 KB: 215 KB.
//     Layer2 streamed (mid 128): 4 stages of 41 KB (a halo box and a w1
//     panel; a w2 tap or a w3 chunk is 32 KB), y1 51 KB, 2 KB: 217 KB. The
//     layer2 widths' weights (544 KB) cannot be resident: K1 refuses them.
//
// The roles, barriers, copies and descriptors are hopper.cuh's (shared with K3).
// Built with -DBOTTLENECK_PROFILE (dir_tpu_torch/profile_kernels.py), one
// consumer thread and the producer sum clock64() per phase; the main path's
// build never sets it.
//
// C interface (bound with ctypes): fused_bottleneck_bf16 launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "wgmma_bf16.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;                          // output rows of a tile
constexpr int TW = 16;                         // output columns of a tile
constexpr int HALO_W = TW + 2;                 // 18
constexpr int HALO = (TH + 2) * HALO_W;        // 180 halo pixels
constexpr int HALO_ROWS = 192;                 // conv1's three 64-row wgmma tiles
constexpr int BOX_H = TH + 3;                  // the TMA box: 18 x 11 = 198 >= 192 rows
constexpr int KC = 64;                         // channels of a chunk: one 128-byte row
constexpr int ROW = 128;                       // bytes of a row of a chunk or a weight panel
constexpr int X_BYTES = HALO_W * BOX_H * ROW;  // 25,344 bytes a halo box delivers
constexpr int X_SLOT = 25 * 1024;              // ... rounded up to the 1024-byte swizzle atom
constexpr int XC_BYTES = TH * TW * ROW;        // 16,384: the tile's own pixels, one chunk
constexpr int MAX_STAGES = 6;
constexpr int BAR_BYTES = 1024;                // the mbarriers, ahead of the ring
constexpr int MAX_SMEM = 232448;               // H100: 227 KB of dynamic shared memory per block
constexpr int Y1_SKEW = 8;                     // y1 row padding (elements): ldmatrix rows in distinct banks

// Everything the kernel reads beside the two tensor maps.
struct Params {
  const bf16* x;                  // (B, H, W, C), for the identity residual
  const unsigned char* image;     // the weight images (ops/fused_bottleneck.py:kernel_operands)
  const float* b1;
  const float* b2;
  const float* b3;
  const float* bd;
  bf16* out;                      // (B, H, W, O)
  int H, W, C, O;
  int ntx, nty, tiles;
  int nk;                         // conv1's chunks of 64 input channels
  int nj;                         // conv3's chunks of N3 output channels
  int has_down;
  int stages;
  int stage_bytes;
  int w2_off, w3_off, wd_off;     // byte offsets of the images (w1's is 0)
};

// Widths and image sizes that follow from mid (M).
template <int M>
struct Shape {
  static constexpr int N1 = M / 2;              // conv1 columns of one consumer warpgroup
  static constexpr int KP = (M + KC - 1) / KC;  // 64-wide K panels of conv2 and conv3
  static constexpr int KS = M / 16;             // their k16 steps
  static constexpr int N3 = M < 32 ? 32 : M;    // output channels of a conv3 chunk
  static constexpr int LDY = M + Y1_SKEW;
  static constexpr int W1P = M * ROW;           // bytes of one w1 panel (64 input channels)
  static constexpr int W2T = KP * M * ROW;      // bytes of one 3x3 tap of w2
  static constexpr int W3C = KP * N3 * ROW;     // bytes of one conv3 chunk of w3
  static constexpr int WDP = N3 * ROW;          // bytes of one wd panel
};

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const __nv_bfloat162* t = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(t[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// The producer: one thread issues every copy, in the order the consumers use
// them, through the ring of stages. Per tile: conv1's nk chunks (the x halo
// box, plus the chunk's w1 panel when streamed); when streamed, the nine w2
// taps; then per conv3 chunk j its w3 block when streamed, and with the
// projection nk pairs (the tile's own pixels, wd's panel).
template <int M, bool RESIDENT>
__device__ __forceinline__ void produce(const CUtensorMap* tm_halo, const CUtensorMap* tm_center,
                                        const Params& p, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, uint64_t* wbar, unsigned char* wres) {
  using S = Shape<M>;
  PROF_DECL
  if (RESIDENT) {
    // w1, w2 and w3 stay for the block's life
    mbar_expect_tx(wbar, (uint32_t)p.wd_off);
    for (int off = 0; off < p.wd_off; off += 16384)
      bulk_copy(wres + off, p.image + off, (uint32_t)min(16384, p.wd_off - off), wbar);
  }
  uint32_t it = 0;
  unsigned char* st = nullptr;
  uint64_t* bar = nullptr;
  auto acquire = [&](uint32_t bytes) {
    const int s = (int)(it % (uint32_t)p.stages);
    mbar_wait(&empty[s], ((it / (uint32_t)p.stages) & 1) ^ 1);
    PROF(0)
    mbar_expect_tx(&full[s], bytes);
    st = ring + s * p.stage_bytes;
    bar = &full[s];
    ++it;
  };
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int tx = tile % p.ntx;
    const int ty = (tile / p.ntx) % p.nty;
    const int n = tile / (p.ntx * p.nty);
    for (int kc = 0; kc < p.nk; ++kc) {
      acquire(X_BYTES + (RESIDENT ? 0 : S::W1P));
      tma_box(st, tm_halo, bar, kc * KC, tx * TW - 1, ty * TH - 1, n);
      if (!RESIDENT) bulk_copy(st + X_SLOT, p.image + kc * S::W1P, S::W1P, bar);
      PROF(1)
    }
    if (!RESIDENT) {
      for (int t = 0; t < 9; ++t) {
        acquire(S::W2T);
        bulk_copy(st, p.image + p.w2_off + t * S::W2T, S::W2T, bar);
        PROF(1)
      }
    }
    for (int j = 0; j < p.nj; ++j) {
      if (!RESIDENT) {
        acquire(S::W3C);
        bulk_copy(st, p.image + p.w3_off + j * S::W3C, S::W3C, bar);
        PROF(1)
      }
      if (p.has_down) {
        for (int kc = 0; kc < p.nk; ++kc) {
          acquire(XC_BYTES + S::WDP);
          tma_box(st, tm_center, bar, kc * KC, tx * TW, ty * TH, n);
          bulk_copy(st + XC_BYTES, p.image + p.wd_off + (j * p.nk + kc) * S::WDP, S::WDP, bar);
          PROF(1)
        }
      }
    }
    PROF_COUNT(15)
  }
  PROF_FLUSH(16)
}

// The two consumer warpgroups. Warpgroup wg computes conv1's mid columns
// [wg * M/2, (wg + 1) * M/2) over all 192 halo rows (the halo's three 64-row
// tiles, split by columns so that both do the same work), then conv2 and
// conv3 for its own 64 output pixels: output rows 4 wg .. 4 wg + 3, one per
// warp.
template <int M, bool RESIDENT>
__device__ __forceinline__ void consume(const Params& p, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, uint64_t* wbar,
                                        const unsigned char* wres, bf16* y1) {
  using S = Shape<M>;
  constexpr int N1 = S::N1, N3 = S::N3, KS = S::KS, LDY = S::LDY;
  PROF_DECL
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int oy = 4 * wg + warp;              // this warp's output row of the tile
  uint32_t it = 0;
  auto wait_stage = [&]() -> int {
    const int s = (int)(it % (uint32_t)p.stages);
    mbar_wait(&full[s], (it / (uint32_t)p.stages) & 1);
    ++it;
    return s;
  };
  // each consumer warp releases a stage once its products have read it
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  if (RESIDENT) mbar_wait(wbar, 0);
  PROF(0)

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int tx0 = (tile % p.ntx) * TW;
    const int ty0 = ((tile / p.ntx) % p.nty) * TH;
    const int n = tile / (p.ntx * p.nty);

    // conv1: acc1[i] is halo rows 64 i .. 64 i + 63, N1 mid columns
    float acc1[3][N1 / 2];
#pragma unroll
    for (int i = 0; i < 3; ++i) zero(acc1[i]);
    // one chunk's products stay in flight while the next chunk is awaited:
    // a stage is released once the products after it were issued
    int prev = -1;
    for (int kc = 0; kc < p.nk; ++kc) {
      const int s = wait_stage();
      PROF(1)
      const unsigned char* st = ring + s * p.stage_bytes;
      const unsigned char* w1p = RESIDENT ? wres + kc * S::W1P : st + X_SLOT;
      const uint64_t bdesc = desc_sw128(w1p + wg * N1 * ROW);
      const uint64_t adesc = desc_sw128(st);
      wg_fence();
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<N1>::ss(acc1[i], adesc + i * (64 * ROW / 16) + kk * 2, bdesc + kk * 2);
      wg_commit();
      wg_wait<1>();
      if (prev >= 0) release(prev);
      prev = s;
      PROF(2)
    }
    wg_wait_all();
#pragma unroll
    for (int i = 0; i < 3; ++i) fence_regs(acc1[i]);
    release(prev);

    // y1 = relu(conv1 + b1) into shared memory, 0 outside the image (conv2's
    // zero padding) and in the padding rows. The barrier before: the other
    // warpgroup has finished reading the last tile's y1.
    consumers_sync();
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 64 * i + 16 * warp + g + 8 * hf;
        const int gy = ty0 - 1 + r / HALO_W;
        const int gx = tx0 - 1 + r % HALO_W;
        const bool inside = r < HALO && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
#pragma unroll
        for (int jn = 0; jn < N1 / 8; ++jn) {
          const int ch = wg * N1 + 8 * jn + 2 * tig;
          const float2 b = __ldg(reinterpret_cast<const float2*>(p.b1 + ch));
          const float v0 = inside ? fmaxf(acc1[i][4 * jn + 2 * hf] + b.x, 0.0f) : 0.0f;
          const float v1 = inside ? fmaxf(acc1[i][4 * jn + 2 * hf + 1] + b.y, 0.0f) : 0.0f;
          *reinterpret_cast<uint32_t*>(y1 + r * LDY + ch) = pack2(v0, v1);
        }
      }
    }
    consumers_sync();
    PROF(3)

    // conv2: nine taps; tap (dy, dx) of output row oy reads the 16 halo rows
    // from (oy + dy) * 18 + dx, as A registers loaded by ldmatrix
    float acc2[M / 2];
    zero(acc2);
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int akof = (lane >> 4) * 8;
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3;
      const int dx = t - dy * 3;
      int s = 0;
      const unsigned char* w2t;
      if (RESIDENT) {
        w2t = wres + p.w2_off + t * S::W2T;
      } else {
        s = wait_stage();
        w2t = ring + s * p.stage_bytes;
      }
      PROF(4)
      const bf16* a0 = y1 + ((oy + dy) * HALO_W + dx + arow) * LDY + akof;
      uint32_t a[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(a[kk], a0 + kk * 16);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        Wgmma<M>::rs(acc2, a[kk], desc_sw128(w2t + (kk / 4) * M * ROW) + (kk % 4) * 2);
      wg_commit();
      wg_wait_all();
      fence_regs(acc2);
      if (!RESIDENT) release(s);
      PROF(5)
    }

    // y2 = bf16(relu(conv2 + b2)) stays in registers: the accumulator layout
    // of two neighbouring 8-column tiles is the A register layout of one k16
    // step of conv3
    uint32_t y2[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int jn = 2 * kk + (h >> 1);
        const int idx = 4 * jn + 2 * (h & 1);
        const float2 b = __ldg(reinterpret_cast<const float2*>(p.b2 + 8 * jn + 2 * tig));
        y2[kk][h] = pack2(fmaxf(acc2[idx] + b.x, 0.0f), fmaxf(acc2[idx + 1] + b.y, 0.0f));
      }
    }
    PROF(6)

    // conv3 and the residual, N3 output channels at a time. The wrapper
    // ordered every 32 columns of w3 and wd so that a thread's eight values
    // of four 8-column tiles are eight consecutive channels. The two
    // residual forms are two code paths, so that neither keeps the other's
    // registers.
    bf16* outn = p.out + (size_t)n * p.H * p.W * p.O;
    const bf16* xn = p.x + (size_t)n * p.H * p.W * p.C;
    const int gy = ty0 + oy;
    auto conv3 = [&](auto down) {
      constexpr bool DOWN = decltype(down)::value;
      // the identity residual is loaded from L2 a chunk ahead, so that the
      // loads' latency hides behind the products and the epilogue
      auto load_residual = [&](int j, uint4(&r)[N3 / 32][2]) {
#pragma unroll
        for (int q = 0; q < N3 / 32; ++q) {
          const int ch = j * N3 + 32 * q + 8 * tig;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int gx = tx0 + g + 8 * hf;
            r[q][hf] = make_uint4(0u, 0u, 0u, 0u);
            if (j < p.nj && gy < p.H && gx < p.W && ch < p.O)
              r[q][hf] = __ldg(reinterpret_cast<const uint4*>(
                  xn + ((size_t)gy * p.W + gx) * p.C + ch));
          }
        }
      };
      uint4 resv[N3 / 32][2], resn[N3 / 32][2];
      if (!DOWN) load_residual(0, resv);
      for (int j = 0; j < p.nj; ++j) {
        float acc3[N3 / 2];
        zero(acc3);
        int s = 0;
        const unsigned char* w3c;
        if (RESIDENT) {
          w3c = wres + p.w3_off + j * S::W3C;
        } else {
          s = wait_stage();
          w3c = ring + s * p.stage_bytes;
        }
        PROF(7)
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          Wgmma<N3>::rs(acc3, y2[kk], desc_sw128(w3c + (kk / 4) * N3 * ROW) + (kk % 4) * 2);
        wg_commit();
        if (!DOWN) load_residual(j + 1, resn);
        wg_wait_all();
        fence_regs(acc3);
        if (!RESIDENT) release(s);
        PROF(8)
        float accd[DOWN ? N3 / 2 : 1];
        if constexpr (DOWN) {
          zero(accd);
          for (int kc = 0; kc < p.nk; ++kc) {
            const int sd = wait_stage();
            PROF(7)
            const unsigned char* st = ring + sd * p.stage_bytes;
            const uint64_t adesc = desc_sw128(st + wg * 64 * ROW);
            const uint64_t bdesc = desc_sw128(st + XC_BYTES);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) Wgmma<N3>::ss(accd, adesc + kk * 2, bdesc + kk * 2);
            wg_commit();
            wg_wait_all();
            fence_regs(accd);
            release(sd);
            PROF(8)
          }
        }

#pragma unroll
        for (int q = 0; q < N3 / 32; ++q) {
          const int ch = j * N3 + 32 * q + 8 * tig;
          float b3[8], bd[8];
          *reinterpret_cast<float4*>(b3) = __ldg(reinterpret_cast<const float4*>(p.b3 + ch));
          *reinterpret_cast<float4*>(b3 + 4) = __ldg(reinterpret_cast<const float4*>(p.b3 + ch + 4));
          if (DOWN) {
            *reinterpret_cast<float4*>(bd) = __ldg(reinterpret_cast<const float4*>(p.bd + ch));
            *reinterpret_cast<float4*>(bd + 4) =
                __ldg(reinterpret_cast<const float4*>(p.bd + ch + 4));
          }
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int gx = tx0 + g + 8 * hf;
            if (gy < p.H && gx < p.W && ch < p.O) {
              float y3[8], res[8];
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int a = 4 * (4 * q + jj) + 2 * hf + e;
                  y3[2 * jj + e] = round_bf16(acc3[a] + b3[2 * jj + e]);
                  if constexpr (DOWN) res[2 * jj + e] = round_bf16(accd[a] + bd[2 * jj + e]);
                }
              if (!DOWN) unpack8(resv[q][hf], res);
              // the add runs in bf16: the sum is rounded (by the pack), and
              // relu commutes with the rounding
              uint4 o;
              uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
              for (int k = 0; k < 4; ++k)
                ow[k] = pack2(fmaxf(y3[2 * k] + res[2 * k], 0.0f),
                              fmaxf(y3[2 * k + 1] + res[2 * k + 1], 0.0f));
              *reinterpret_cast<uint4*>(outn + ((size_t)gy * p.W + gx) * p.O + ch) = o;
            }
          }
        }
        if (!DOWN) {
#pragma unroll
          for (int q = 0; q < N3 / 32; ++q) {
            resv[q][0] = resn[q][0];
            resv[q][1] = resn[q][1];
          }
        }
        PROF(9)
      }
    };
    if (p.has_down)
      conv3(std::true_type{});
    else
      conv3(std::false_type{});
    PROF_COUNT(15)
  }
  if (threadIdx.x == 0) {
    PROF_FLUSH(0)
  }
}

template <int M, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    fused_bottleneck_kernel(const __grid_constant__ CUtensorMap tm_halo,
                            const __grid_constant__ CUtensorMap tm_center,
                            const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  // the ring's stages start on 1024-byte boundaries (the swizzle atom)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* wbar = empty + MAX_STAGES;
  unsigned char* ring = smem + BAR_BYTES;
  unsigned char* wres = ring + p.stages * p.stage_bytes;
  bf16* y1 = reinterpret_cast<bf16*>(wres + (RESIDENT ? p.wd_off : 0));

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // registers move from the producer warpgroup to the consumers
  if (threadIdx.x >= CONSUMERS * 128) {
    producer_registers();
    if (threadIdx.x == CONSUMERS * 128)
      produce<M, RESIDENT>(&tm_halo, &tm_center, p, ring, full, empty, wbar, wres);
  } else {
    consumer_registers();
    consume<M, RESIDENT>(p, ring, full, empty, wbar, wres, y1);
  }
}

// Bytes of the weight images, in the order w1, w2, w3, wd.
struct Layout {
  int w2_off, w3_off, wd_off, end;
  int nk, nj, stage_bytes;
};

template <int M>
Layout layout(int C, int O, int has_down, bool resident) {
  using S = Shape<M>;
  Layout l;
  l.nk = (C + KC - 1) / KC;
  l.nj = round_up(O, S::N3) / S::N3;
  l.w2_off = l.nk * S::W1P;
  l.w3_off = l.w2_off + 9 * S::W2T;
  l.wd_off = l.w3_off + l.nj * S::W3C;
  l.end = l.wd_off + (has_down ? l.nj * l.nk * S::WDP : 0);
  int stage = X_SLOT;
  if (has_down) stage = std::max(stage, XC_BYTES + S::WDP);
  if (!resident) stage = std::max({stage, X_SLOT + S::W1P, S::W2T, S::W3C});
  l.stage_bytes = round_up(stage, 1024);
  return l;
}

// Dynamic shared memory of a block with `stages` stages.
template <int M>
int smem_bytes(const Layout& l, bool resident, int stages) {
  return 1024 + BAR_BYTES + stages * l.stage_bytes + (resident ? l.wd_off : 0) +
         HALO_ROWS * Shape<M>::LDY * 2;
}


template <int M, bool RESIDENT>
int launch(const void* x, const void* image, const void* b1, const void* b2, const void* b3,
           const void* bd, void* out, int B, int H, int W, int C, int O, int has_down,
           void* stream) {
  const Layout l = layout<M>(C, O, has_down, RESIDENT);
  int stages = MAX_STAGES;
  while (stages > 2 && smem_bytes<M>(l, RESIDENT, stages) > MAX_SMEM) --stages;
  const int smem = smem_bytes<M>(l, RESIDENT, stages);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_halo, tm_center;
  if (!encode_nhwc(&tm_halo, x, B, H, W, C, HALO_W, BOX_H) ||
      !encode_nhwc(&tm_center, x, B, H, W, C, TW, TH))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = (const bf16*)x;
  p.image = (const unsigned char*)image;
  p.b1 = (const float*)b1;
  p.b2 = (const float*)b2;
  p.b3 = (const float*)b3;
  p.bd = (const float*)bd;
  p.out = (bf16*)out;
  p.H = H;
  p.W = W;
  p.C = C;
  p.O = O;
  p.ntx = (W + TW - 1) / TW;
  p.nty = (H + TH - 1) / TH;
  p.tiles = B * p.ntx * p.nty;
  p.nk = l.nk;
  p.nj = l.nj;
  p.has_down = has_down;
  p.stages = stages;
  p.stage_bytes = l.stage_bytes;
  p.w2_off = l.w2_off;
  p.w3_off = l.w3_off;
  p.wd_off = l.wd_off;
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_kernel<M, RESIDENT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block an SM, each walking tiles blockIdx.x, + gridDim.x, ...
  const int grid = std::min(p.tiles, sm_count());
  fused_bottleneck_kernel<M, RESIDENT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tm_halo, tm_center, p);
  return (int)cudaGetLastError();
}

template <int M>
int dispatch(const void* x, const void* image, const void* b1, const void* b2, const void* b3,
             const void* bd, void* out, int B, int H, int W, int C, int O, int has_down,
             int resident, void* stream) {
  return resident ? launch<M, true>(x, image, b1, b2, b3, bd, out, B, H, W, C, O, has_down, stream)
                  : launch<M, false>(x, image, b1, b2, b3, bd, out, B, H, W, C, O, has_down,
                                     stream);
}

bool takes(int C, int M, int O, int has_down) {
  return C > 0 && O > 0 && C % 16 == 0 && O % 16 == 0 &&
         (M == 16 || M == 32 || M == 64 || M == 128) && (has_down || O == C);
}

}  // namespace

// Bytes of the weight images fused_bottleneck_bf16 reads for these widths (-1
// for widths it does not take).
extern "C" int fused_bottleneck_image_bytes(int C, int M, int O, int has_down) {
  if (!takes(C, M, O, has_down)) return -1;
  switch (M) {
    case 16: return layout<16>(C, O, has_down, true).end;
    case 32: return layout<32>(C, O, has_down, true).end;
    case 64: return layout<64>(C, O, has_down, true).end;
    default: return layout<128>(C, O, has_down, true).end;
  }
}

// The least dynamic shared memory a block of the resident (K1) or streamed
// (K2) form needs, with two stages (-1 for widths it does not take).
extern "C" int fused_bottleneck_smem_bytes(int C, int M, int O, int has_down, int resident) {
  if (!takes(C, M, O, has_down)) return -1;
  switch (M) {
    case 16: return smem_bytes<16>(layout<16>(C, O, has_down, resident), resident, 2);
    case 32: return smem_bytes<32>(layout<32>(C, O, has_down, resident), resident, 2);
    case 64: return smem_bytes<64>(layout<64>(C, O, has_down, resident), resident, 2);
    default: return smem_bytes<128>(layout<128>(C, O, has_down, resident), resident, 2);
  }
}

// x (B, H, W, C) bf16; image: the weight images of kernel_operands (bf16); b1,
// b2 (M,), b3 and bd (O,) fp32 in channel order; out (B, H, W, O) bf16.
// resident 1 launches K1 (w1, w2, w3 kept in shared memory), 0 K2 (every
// weight streamed). Launches on the given stream, allocates nothing, does not
// synchronise; returns cudaGetLastError(), or cudaErrorInvalidValue for
// shapes it does not take.
extern "C" int fused_bottleneck_bf16(const void* x, const void* image, const void* b1,
                                     const void* b2, const void* b3, const void* bd, void* out,
                                     int B, int H, int W, int C, int M, int O, int has_down,
                                     int resident, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || !takes(C, M, O, has_down))
    return (int)cudaErrorInvalidValue;
  switch (M) {
    case 16:
      return dispatch<16>(x, image, b1, b2, b3, bd, out, B, H, W, C, O, has_down, resident,
                          stream);
    case 32:
      return dispatch<32>(x, image, b1, b2, b3, bd, out, B, H, W, C, O, has_down, resident,
                          stream);
    case 64:
      return dispatch<64>(x, image, b1, b2, b3, bd, out, B, H, W, C, O, has_down, resident,
                          stream);
    default:
      return dispatch<128>(x, image, b1, b2, b3, bd, out, B, H, W, C, O, has_down, resident,
                           stream);
  }
}

extern "C" const char* fused_bottleneck_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef BOTTLENECK_PROFILE
extern "C" int fused_bottleneck_prof_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}

extern "C" int fused_bottleneck_prof_reset() {
  const unsigned long long z[32] = {};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(g_prof));
}
#endif
