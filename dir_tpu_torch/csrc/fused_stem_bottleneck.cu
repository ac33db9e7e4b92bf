// Stem BN + ReLU + 3x3/2 max pool + the projection bottleneck (layer1_0) in one
// kernel, fed by the raw stem-conv output, bf16 in and out, for Hopper
// (sm_90a). Kernel K4.
//
// Replaces dir_tpu/ops/pallas_bottleneck.py:_stem_kernel (reached by
// fused_stem_bottleneck). With the BNs folded beforehand it computes
//   a      = relu(bf16(bf16(x * bf16(g1)) + bf16(t1)))   the affine runs in bf16
//   pooled = maxpool3x3, stride 2, zero padding 1 (exact: a >= 0 and every
//            window holds a real pixel)
//   y1     = bf16(relu(pooled . w1 + b1))                zero outside the map
//   y2     = bf16(relu(conv3x3(y1, w2) + b2))
//   out    = bf16(relu(bf16(y2 . w3 + b3) + bf16(pooled . wd + bd)))
// with bf16 operands and fp32 accumulation. The TPU kernel's paired-W input
// layout and its row bands serve its lanes and its fast memory and are not
// carried over: x is plain NHWC (B, 2H, 2W, C); H and W are the pooled map's.
//
// What bounds it on an H100: at the stem's shape, x (B, 128, 128, 64) ->
// (B, 64, 64, 256), mid 64, input and output are B*(128*128*64 + 64*64*256)*2
// bytes (1.07 GB at B = 256, 0.32 ms at 3.35 TB/s) against
// 2*B*4096*(64*64 + 9*64*64 + 64*256 + 64*256) = 146 GFLOP (0.15 ms at 989
// TFLOP/s): device-memory bytes.
//
// The design is the persistent, warp-specialised template of the bf16
// bottleneck kernels (fused_bottleneck.cu) on hopper.cuh's plumbing, with the
// stem's prologue in front of conv1. The activated and pooled maps and the
// block's intermediates never reach device memory.
//   Tiles. A tile is 8x16 pooled pixels of one sample; conv1 runs over its
//     10x18 pooled halo (three 64-row wgmma tiles, 192 rows). One block an SM
//     walks the tiles (n, ty, tx) in a static stride.
//   Raw input by TMA, in row strips. The halo needs a 21x37 window of raw
//     pixels (99 KB at 64 channels), which does not fit beside the weights.
//     A strip is a box of 64 channels x 37 x 5 raw rows (23,680 bytes,
//     128-byte swizzle) and makes two pooled halo rows; five strips make a
//     tile, re-reading one raw row in five (from L2). The box's origin may be
//     negative; TMA fills with NaN outside x (the pool drops those pixels).
//   Roles. One producer thread issues every strip into a ring of 2-4 stages
//     guarded by full and empty mbarriers, each strip prefetched into L2 two
//     strips before its load; two consumer warpgroups (setmaxnreg: 224
//     registers, the producer's 56) pool and run every product as wgmma.
//     Every wait is bounded: a fault traps.
//   The pool. A zero fill would not be the pool's padding: a zero raw pixel
//     becomes relu(bf16(t1)). The strip's map fills with NaN instead, outside
//     [0, 2H) x [0, 2W) and beyond C, and max.bf16x2 returns the other
//     operand of a NaN: each consumer thread makes eight channels of one
//     pooled pixel as the max, from 0, of the affine of the nine raw pixels
//     of its window, and a pixel outside x drops out without a branch or any
//     bounds arithmetic (channels beyond C stay 0, as w1's and wd's K
//     padding expects). The affine is mul.rn.bf16x2 then add.rn.bf16x2: each
//     rounds the exact result once, which is what the plain version's fp32
//     product (exact for bf16 operands) and fp32 sum (rounded twice, to the
//     same bf16) give, and two instructions with their own rounding are never
//     contracted into an FMA. A strip's 288 units (36 pooled pixels x 8
//     chunks of 8 channels) are nine warp rounds; warp w takes rounds
//     w - s mod 8 (and round 8 when that is 0) of strip s, so the extra round
//     rotates.
//   When the pool runs. Once both warpgroups have finished conv2, y1's space
//     (which the pooled halo shares) is free: while the products of conv3's
//     chunk j run, the warps pool the next tile's strip j, and a tile starts
//     by pooling the strips not yet pooled (one at the stem's widths). The
//     products hide behind the pool, and the ring's stages free earlier.
//   The pooled halo is written as TMA would write it: 192 rows of 128 bytes,
//     the 16-byte chunk c of row r at chunk c ^ (r % 8), rows 180-191 zero.
//     conv1 reads it through a descriptor (ss wgmma), each consumer
//     warpgroup taking half of mid's columns over all 192 rows.
//   The projection's A is the tile's own 128 pooled pixels, halo rows
//     (r + 1) * 18 + 1 ... + 16, which no descriptor addresses (not 8-row
//     aligned): each warp loads its output row's 16 pixels by ldmatrix
//     (swizzled addresses) into registers while conv1 runs, and the
//     projection is an rs wgmma beside conv3's.
//   y1 takes the pooled halo's place once conv1 and those loads are done
//     (rows padded by 16 bytes: ldmatrix without conflicts); conv2 (nine taps,
//     rs wgmma on ldmatrix windows of y1), conv3 (rs wgmma on conv2's
//     accumulators rounded in registers) and the epilogue (16-byte stores,
//     w3's and wd's columns in ops/fused_bottleneck.py:channel_order) are the
//     bf16 bottleneck kernel's, but that the epilogue rounds y3 and the
//     residual with one cvt a pair and adds them with one fma.rn.relu.bf16x2.
//   Weights and vectors. The weight image is ops/fused_bottleneck.py's for
//     the projection form (w1, w2, w3, wd as swizzled K-major panels, C and
//     mid zero-padded to one 64-wide panel) and stays in shared memory for the
//     block's life; g1, t1 (bf16) and the biases are copied into shared
//     memory once per block and read there.
//   Shared memory at the stem's widths (C 64, mid 64, O 256): weights 144 KB
//     (w1 8, w2 72, w3 32, wd 32), 2 strip stages of 24 KB, the pooled halo
//     and then y1 27 KB, vectors 3 KB, barriers and alignment 2 KB: 224 KB of
//     the 227. Narrower widths leave room for up to 4 stages.
//
// Built with -DBOTTLENECK_PROFILE (dir_tpu_torch/profile_kernels.py), one
// consumer thread and the producer sum clock() per phase; the main path's
// build never sets it.
//
// C interface (bound with ctypes): fused_stem_bottleneck_bf16 launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "wgmma_bf16.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;                           // pooled rows of a tile
constexpr int TW = 16;                          // pooled columns of a tile
constexpr int HALO_W = TW + 2;                  // 18
constexpr int HALO = (TH + 2) * HALO_W;         // 180 pooled halo pixels
constexpr int HALO_ROWS = 192;                  // conv1's three 64-row wgmma tiles
constexpr int KC = 64;                          // channels of a strip: one 128-byte row
constexpr int ROW = 128;                        // bytes of a strip, halo or weight panel row
constexpr int STRIPS = (TH + 2) / 2;            // 5 strips a tile, two pooled halo rows each
constexpr int STRIP_W = 2 * HALO_W + 1;         // 37 raw columns
constexpr int STRIP_H = 5;                      // raw rows
constexpr int STRIP_BYTES = STRIP_W * STRIP_H * ROW;  // 23,680 bytes a strip box delivers
constexpr int STRIP_SLOT = 24 * 1024;           // ... rounded up to the 1024-byte swizzle atom
constexpr int STRIP_ROUNDS = 2 * HALO_W * 8 / 32;     // 9 warp rounds of (pixel, 8 channels) units
constexpr int MAX_STAGES = 4;
constexpr int BAR_BYTES = 1024;                 // the mbarriers, ahead of the ring
constexpr int MAX_SMEM = 232448;                // H100: 227 KB of dynamic shared memory per block
constexpr int Y1_SKEW = 8;                      // y1 row padding (elements)
constexpr int GT_BYTES = 2 * KC * 2;            // g1 and t1, bf16, padded to 64 channels

// Everything the kernel reads beside the tensor map.
struct Params {
  const unsigned char* image;     // the weight image (ops/fused_stem_bottleneck.py:kernel_operands)
  const float* vec;               // b1 (M), b2 (M), b3 (OP), bd (OP)
  const bf16* gt;                 // g1 (64), t1 (64)
  bf16* out;                      // (B, H, W, O)
  int H, W, O, OP;                // the pooled map; output channels, padded to whole chunks
  int ntx, nty, tiles;
  int nj;                         // conv3's chunks of N3 output channels
  int stages;
  int w2_off, w3_off, wd_off, image_bytes;
};

// Widths and image sizes that follow from mid (M <= 64: K of every product is
// one 64-wide panel).
template <int M>
struct Shape {
  static constexpr int N1 = M / 2;              // conv1 columns of one consumer warpgroup
  static constexpr int KS = M / 16;             // k16 steps of conv2 and conv3
  static constexpr int N3 = M < 32 ? 32 : M;    // output channels of a conv3 chunk
  static constexpr int LDY = M + Y1_SKEW;
  static constexpr int W2T = M * ROW;           // bytes of one 3x3 tap of w2
  static constexpr int W3C = N3 * ROW;          // bytes of one conv3 chunk of w3 (and of wd)
  // the pooled halo (192 swizzled rows), then y1 in its place
  static constexpr int HALO_BYTES =
      round_up(HALO_ROWS * LDY * 2 > HALO_ROWS * ROW ? HALO_ROWS * LDY * 2 : HALO_ROWS * ROW, 1024);
};

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&t);
}

// bf16x2 arithmetic, each rounding the exact result once to nearest even
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// the other operand where one is NaN
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// relu(a + b)
__device__ __forceinline__ uint32_t add_relu_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}

// Byte offset of the 16-byte chunk c of row r in 128-byte-swizzled rows.
__device__ __forceinline__ int swizzled(int r, int c) { return r * ROW + ((c ^ (r & 7)) << 4); }

// The producer: one thread loads the weight image once, then issues each
// tile's five strips, in order, through the ring, each prefetched into L2 as
// the strip two places before it is loaded.
__device__ __forceinline__ void produce(const CUtensorMap* tm, const Params& p,
                                        unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        uint64_t* wbar, unsigned char* wres) {
  PROF_DECL
  mbar_expect_tx(wbar, (uint32_t)p.image_bytes);
  for (int off = 0; off < p.image_bytes; off += 16384)
    bulk_copy(wres + off, p.image + off, (uint32_t)min(16384, p.image_bytes - off), wbar);
  // the box origin of strip s of a tile (s may run into the block's next
  // tile): pooled halo rows 2s, 2s + 1 are pooled rows ty*8 - 1 + 2s ...,
  // whose windows start at raw row 2 (ty*8 - 1 + 2s) - 1; likewise columns
  struct Origin {
    int x, y, n;
    bool valid;
  };
  auto origin = [&](int tile, int s) {
    if (s >= STRIPS) {
      tile += gridDim.x;
      s -= STRIPS;
    }
    const int tx = tile % p.ntx;
    const int ty = (tile / p.ntx) % p.nty;
    return Origin{2 * tx * TW - 3, 2 * ty * TH - 3 + 4 * s, tile / (p.ntx * p.nty),
                  tile < p.tiles};
  };
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    for (int s = 0; s < STRIPS; ++s, ++it) {
      const Origin ahead = origin(tile, s + 2);
      if (ahead.valid) tma_prefetch(tm, 0, ahead.x, ahead.y, ahead.n);
      const int st = (int)(it % (uint32_t)p.stages);
      mbar_wait(&empty[st], ((it / (uint32_t)p.stages) & 1) ^ 1);
      PROF(0)
      mbar_expect_tx(&full[st], STRIP_BYTES);
      const Origin o = origin(tile, s);
      tma_box(ring + st * STRIP_SLOT, tm, &full[st], 0, o.x, o.y, o.n);
      PROF(1)
    }
    PROF_COUNT(15)
  }
  PROF_FLUSH(16)
}

// The two consumer warpgroups. Per tile: all eight warps pool the five strips
// into the pooled halo (those of the next tile during this one's conv3, as
// far as it has chunks); warpgroup wg computes conv1's mid columns [wg * M/2,
// (wg + 1) * M/2) over all 192 halo rows, then conv2, conv3 and the
// projection for its own 64 pixels: output rows 4 wg .. 4 wg + 3, one per
// warp.
template <int M>
__device__ __forceinline__ void consume(const Params& p, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, uint64_t* wbar,
                                        const unsigned char* wres, unsigned char* halo,
                                        const float* vec, const uint4* gt) {
  using S = Shape<M>;
  constexpr int N1 = S::N1, N3 = S::N3, KS = S::KS, LDY = S::LDY;
  PROF_DECL
  const int wid = threadIdx.x / 32;          // 0..7
  const int wg = wid / 4;
  const int warp = wid % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int oy = 4 * wg + warp;              // this warp's output row of the tile
  bf16* y1 = reinterpret_cast<bf16*>(halo);
  const float* b1 = vec;
  const float* b2 = vec + M;
  const float* b3 = vec + 2 * M;
  const float* bd = b3 + p.OP;
  // the pool: this lane's eight channels are chunk k = lane % 8 of every pixel
  // it makes; their g1 and t1 as four bf16 pairs each
  const int k = lane & 7;
  const uint4 gk = gt[k];
  const uint4 tk = gt[8 + k];
  const uint32_t* gp = reinterpret_cast<const uint32_t*>(&gk);
  const uint32_t* tp = reinterpret_cast<const uint32_t*>(&tk);
  // ldmatrix lanes: rows 0-7 / 8-15 of a 16-row A tile, k 0-7 / 8-15
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int akof = (lane >> 4) * 8;
  uint32_t it = 0;
  // the ring's next strip, strip s of its tile, pooled into halo rows 2s and
  // 2s + 1; each warp releases the stage once it is done with it
  auto pool_strip = [&](int s) {
    const int stage = (int)(it % (uint32_t)p.stages);
    mbar_wait(&full[stage], (it / (uint32_t)p.stages) & 1);
    ++it;
    PROF(1)
    const unsigned char* strip = ring + stage * STRIP_SLOT;
    for (int q = (wid - s) & 7; q < STRIP_ROUNDS; q += 8) {
      const int pp = 4 * q + (lane >> 3);    // pooled pixel of the strip, 0..35
      const int pr = pp / HALO_W;            // its halo row within the strip, 0..1
      const int pc = pp - pr * HALO_W;       // its halo column
      const int r0 = 2 * pr * STRIP_W + 2 * pc;  // its window's first raw pixel
      uint32_t best[4] = {0u, 0u, 0u, 0u};   // +0: the pool's padding after the ReLU
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(strip + swizzled(r0 + dy * STRIP_W + dx, k));
          const uint32_t* rw = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            best[j] = max_bf16x2(best[j], add_bf16x2(mul_bf16x2(rw[j], gp[j]), tp[j]));
        }
      }
      *reinterpret_cast<uint4*>(halo + swizzled((2 * s + pr) * HALO_W + pc, k)) =
          make_uint4(best[0], best[1], best[2], best[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    PROF(2)
  };
  mbar_wait(wbar, 0);
  PROF(0)

  int ahead = 0;                             // strips of this tile pooled during the last one
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int tx0 = (tile % p.ntx) * TW;
    const int ty0 = ((tile / p.ntx) % p.nty) * TH;
    const int n = tile / (p.ntx * p.nty);
    const bool more = tile + gridDim.x < p.tiles;

    for (int s = ahead; s < STRIPS; ++s) pool_strip(s);
    if (threadIdx.x < (HALO_ROWS - HALO) * 8)   // rows 180-191: zero
      *reinterpret_cast<uint4*>(halo + HALO * ROW + threadIdx.x * 16) = make_uint4(0u, 0u, 0u, 0u);
    // the pooled halo, written by these threads, is read by wgmma
    fence_proxy_async();
    consumers_sync();
    PROF(2)

    // conv1: acc1[i] is halo rows 64 i .. 64 i + 63, N1 mid columns
    float acc1[3][N1 / 2];
#pragma unroll
    for (int i = 0; i < 3; ++i) zero(acc1[i]);
    {
      const uint64_t adesc = desc_sw128(halo);
      const uint64_t bdesc = desc_sw128(wres + wg * N1 * ROW);
      wg_fence();
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<N1>::ss(acc1[i], adesc + i * (64 * ROW / 16) + kk * 2, bdesc + kk * 2);
      wg_commit();
    }
    // meanwhile the projection's A: this warp's 16 tile pixels (output row
    // oy), halo rows (oy + 1) * 18 + 1 ..., all 64 channels
    uint32_t ad[4][4];
    {
      const int r = (oy + 1) * HALO_W + 1 + arow;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(ad[kk], halo + swizzled(r, 2 * kk + (lane >> 4)));
    }
    wg_wait_all();
#pragma unroll
    for (int i = 0; i < 3; ++i) fence_regs(acc1[i]);
    PROF(3)

    // y1 = relu(conv1 + b1) into the pooled halo's place, 0 outside the map
    // (conv2's zero padding) and in the padding rows. The barrier before:
    // both warpgroups' products and loads have read the pooled halo.
    consumers_sync();
#pragma unroll
    for (int jn = 0; jn < N1 / 8; ++jn) {
      const int ch = wg * N1 + 8 * jn + 2 * tig;
      const float2 b = *reinterpret_cast<const float2*>(b1 + ch);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 64 * i + 16 * warp + g + 8 * hf;
          const int gy = ty0 - 1 + r / HALO_W;
          const int gx = tx0 - 1 + r % HALO_W;
          const bool inside = r < HALO && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
          const float v0 = inside ? fmaxf(acc1[i][4 * jn + 2 * hf] + b.x, 0.0f) : 0.0f;
          const float v1 = inside ? fmaxf(acc1[i][4 * jn + 2 * hf + 1] + b.y, 0.0f) : 0.0f;
          *reinterpret_cast<uint32_t*>(y1 + r * LDY + ch) = pack2(v0, v1);
        }
      }
    }
    consumers_sync();
    PROF(4)

    // conv2: nine taps; tap (dy, dx) of output row oy reads the 16 halo rows
    // from (oy + dy) * 18 + dx, as A registers loaded by ldmatrix
    float acc2[M / 2];
    zero(acc2);
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3;
      const int dx = t - dy * 3;
      const unsigned char* w2t = wres + p.w2_off + t * S::W2T;
      const bf16* a0 = y1 + ((oy + dy) * HALO_W + dx + arow) * LDY + akof;
      uint32_t a[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(a[kk], a0 + kk * 16);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) Wgmma<M>::rs(acc2, a[kk], desc_sw128(w2t) + kk * 2);
      wg_commit();
      wg_wait_all();
      fence_regs(acc2);
    }
    PROF(5)
    // from here the next tile's pool may write the pooled halo in y1's
    // place: both warpgroups have read y1
    consumers_sync();

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
        const float2 b = *reinterpret_cast<const float2*>(b2 + 8 * jn + 2 * tig);
        y2[kk][h] = pack2(fmaxf(acc2[idx] + b.x, 0.0f), fmaxf(acc2[idx + 1] + b.y, 0.0f));
      }
    }
    PROF(6)

    // conv3 and the projection, N3 output channels at a time. The wrapper
    // ordered every 32 columns of w3 and wd so that a thread's eight values
    // of four 8-column tiles are eight consecutive channels. While chunk j's
    // products run, the warps pool the next tile's strip j.
    bf16* outn = p.out + (size_t)n * p.H * p.W * p.O;
    const int gy = ty0 + oy;
    for (int j = 0; j < p.nj; ++j) {
      float acc3[N3 / 2], accd[N3 / 2];
      zero(acc3);
      zero(accd);
      const uint64_t w3c = desc_sw128(wres + p.w3_off + j * S::W3C);
      const uint64_t wdc = desc_sw128(wres + p.wd_off + j * S::W3C);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) Wgmma<N3>::rs(acc3, y2[kk], w3c + kk * 2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<N3>::rs(accd, ad[kk], wdc + kk * 2);
      wg_commit();
      if (more && j < STRIPS) pool_strip(j);
      wg_wait_all();
      fence_regs(acc3);
      fence_regs(accd);
      PROF(7)

#pragma unroll
      for (int q = 0; q < N3 / 32; ++q) {
        const int ch = j * N3 + 32 * q + 8 * tig;
        float b3v[8], bdv[8];
        *reinterpret_cast<float4*>(b3v) = *reinterpret_cast<const float4*>(b3 + ch);
        *reinterpret_cast<float4*>(b3v + 4) = *reinterpret_cast<const float4*>(b3 + ch + 4);
        *reinterpret_cast<float4*>(bdv) = *reinterpret_cast<const float4*>(bd + ch);
        *reinterpret_cast<float4*>(bdv + 4) = *reinterpret_cast<const float4*>(bd + ch + 4);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int gx = tx0 + g + 8 * hf;
          if (gy < p.H && gx < p.W && ch < p.O) {
            uint4 o;
            uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int a = 4 * (4 * q + jj) + 2 * hf;
              // y3 and the projected residual each rounded to bf16, then
              // their sum rounded once (as the fp32 sum of two bf16 values
              // rounds to bf16) and ReLU'd
              const uint32_t y3 = pack2(acc3[a] + b3v[2 * jj], acc3[a + 1] + b3v[2 * jj + 1]);
              const uint32_t res = pack2(accd[a] + bdv[2 * jj], accd[a + 1] + bdv[2 * jj + 1]);
              ow[jj] = add_relu_bf16x2(y3, res);
            }
            *reinterpret_cast<uint4*>(outn + ((size_t)gy * p.W + gx) * p.O + ch) = o;
          }
        }
      }
      PROF(8)
    }
    ahead = more ? min(p.nj, STRIPS) : 0;
    PROF_COUNT(15)
  }
  if (threadIdx.x == 0) {
    PROF_FLUSH(0)
  }
}

template <int M>
__global__ void __launch_bounds__(THREADS, 1)
    fused_stem_bottleneck_kernel(const __grid_constant__ CUtensorMap tm_strip,
                                 const __grid_constant__ Params p) {
  using S = Shape<M>;
  extern __shared__ unsigned char smem_raw[];
  // the ring's stages and the pooled halo start on 1024-byte boundaries (the
  // swizzle atom)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* wbar = empty + MAX_STAGES;
  unsigned char* ring = smem + BAR_BYTES;
  unsigned char* wres = ring + p.stages * STRIP_SLOT;
  unsigned char* halo = wres + p.image_bytes;
  uint4* gt = reinterpret_cast<uint4*>(halo + S::HALO_BYTES);
  float* vec = reinterpret_cast<float*>(halo + S::HALO_BYTES + GT_BYTES);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // g1, t1 and the biases into shared memory, read there for the block's life
  for (int i = threadIdx.x; i < GT_BYTES / 16; i += THREADS)
    gt[i] = reinterpret_cast<const uint4*>(p.gt)[i];
  for (int i = threadIdx.x; i < 2 * M + 2 * p.OP; i += THREADS) vec[i] = p.vec[i];
  __syncthreads();

  // registers move from the producer warpgroup to the consumers
  if (threadIdx.x >= CONSUMERS * 128) {
    producer_registers();
    if (threadIdx.x == CONSUMERS * 128) produce(&tm_strip, p, ring, full, empty, wbar, wres);
  } else {
    consumer_registers();
    consume<M>(p, ring, full, empty, wbar, wres, halo, vec, gt);
  }
}

// The weight image (in the order w1, w2, w3, wd) and the block's shared
// memory for these widths.
struct Layout {
  int w2_off, w3_off, wd_off, image_bytes;
  int nj, op;
  int smem, stages;
};

template <int M>
Layout layout(int O) {
  using S = Shape<M>;
  Layout l;
  l.nj = (O + S::N3 - 1) / S::N3;
  l.op = l.nj * S::N3;
  l.w2_off = M * ROW;
  l.w3_off = l.w2_off + 9 * S::W2T;
  l.wd_off = l.w3_off + l.nj * S::W3C;
  l.image_bytes = l.wd_off + l.nj * S::W3C;
  // alignment slack, barriers, weights, halo / y1, g1 and t1, biases
  const int fixed = 1024 + BAR_BYTES + l.image_bytes + S::HALO_BYTES + GT_BYTES +
                    (2 * M + 2 * l.op) * 4;
  l.stages = MAX_STAGES;
  while (l.stages > 2 && fixed + l.stages * STRIP_SLOT > MAX_SMEM) --l.stages;
  l.smem = fixed + l.stages * STRIP_SLOT;
  return l;
}

bool takes(int C, int M, int O) {
  return C > 0 && C <= KC && C % 16 == 0 && O > 0 && O % 16 == 0 &&
         (M == 16 || M == 32 || M == 64);
}

Layout layout_for(int M, int O) {
  switch (M) {
    case 16: return layout<16>(O);
    case 32: return layout<32>(O);
    default: return layout<64>(O);
  }
}

template <int M>
int launch(const void* x, const void* image, const void* vec, const void* gt, void* out, int B,
           int H, int W, int C, int O, void* stream) {
  const Layout l = layout<M>(O);
  if (l.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  if (!encode_nhwc(&tm, x, B, 2 * H, 2 * W, C, STRIP_W, STRIP_H, true))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.image = (const unsigned char*)image;
  p.vec = (const float*)vec;
  p.gt = (const bf16*)gt;
  p.out = (bf16*)out;
  p.H = H;
  p.W = W;
  p.O = O;
  p.OP = l.op;
  p.ntx = (W + TW - 1) / TW;
  p.nty = (H + TH - 1) / TH;
  p.tiles = B * p.ntx * p.nty;
  p.nj = l.nj;
  p.stages = l.stages;
  p.w2_off = l.w2_off;
  p.w3_off = l.w3_off;
  p.wd_off = l.wd_off;
  p.image_bytes = l.image_bytes;
  cudaError_t err = cudaFuncSetAttribute(fused_stem_bottleneck_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block an SM, each walking tiles blockIdx.x, + gridDim.x, ...
  const int grid = std::min(p.tiles, sm_count());
  fused_stem_bottleneck_kernel<M><<<grid, THREADS, l.smem, (cudaStream_t)stream>>>(tm, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The layout of these widths: out[0] the weight image's bytes, out[1] the
// block's dynamic shared memory, out[2] the ring's stages. Returns -1 for
// widths the kernel does not take.
extern "C" int fused_stem_bottleneck_layout(int C, int M, int O, int* out) {
  if (!takes(C, M, O)) return -1;
  const Layout l = layout_for(M, O);
  out[0] = l.image_bytes;
  out[1] = l.smem;
  out[2] = l.stages;
  return 0;
}

// x (B, 2H, 2W, C) bf16; image: the weight image of kernel_operands (bf16);
// vec: b1, b2 (M,), b3, bd (O padded to whole conv3 chunks) fp32 in channel
// order; gt: g1, t1 as bf16, each padded to 64; out (B, H, W, O) bf16. H and
// W are the pooled map's. Launches on the given stream, allocates nothing,
// does not synchronise; returns cudaGetLastError(), or cudaErrorInvalidValue
// for shapes it does not take.
extern "C" int fused_stem_bottleneck_bf16(const void* x, const void* image, const void* vec,
                                          const void* gt, void* out, int B, int H, int W, int C,
                                          int M, int O, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || !takes(C, M, O)) return (int)cudaErrorInvalidValue;
  switch (M) {
    case 16: return launch<16>(x, image, vec, gt, out, B, H, W, C, O, stream);
    case 32: return launch<32>(x, image, vec, gt, out, B, H, W, C, O, stream);
    default: return launch<64>(x, image, vec, gt, out, B, H, W, C, O, stream);
  }
}

extern "C" const char* fused_stem_bottleneck_error_string(int code) {
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
