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
// The design is the bf16 kernels' (fused_bottleneck.cu), on hopper.cuh's
// plumbing: persistent blocks walk 8x16 output tiles (n, ty, tx) in a static
// stride; one producer thread feeds a ring of mbarrier-guarded stages; two
// consumer warpgroups do the math with wgmma (wgmma_s8.cuh); x's 10x18 halo
// (three 64-row wgmma tiles) arrives by TMA as 64-channel bf16 boxes, 128-byte
// swizzled, zero-filled at the image border. What int8 changes:
//   conv1: A is x quantized into shared memory. Both consumer warpgroups
//     quantize each box, each value once, into half of xq: 192 int8 rows of
//     128 bytes (two boxes), swizzled as the weights, which an ss wgmma reads
//     K-major; the products of one box run while the next is quantized. Each
//     warpgroup takes half of mid's columns over all 192 rows. Quantization
//     is clip in fp32, then rint by adding 1.5 * 2^23 (an fp32 add rounds
//     half to even at the integer; the low byte of the sum is the s8): no
//     float-to-int conversion, which runs at a sixteenth of the rate.
//   y1 is stored int8 in xq's place (rows padded by 16 bytes: ldmatrix
//     without conflicts), 0 at halo pixels outside the image: conv2 zero-pads
//     the quantized map, which is not q(relu(b1)).
//   conv2: nine taps; A by ldmatrix at per-lane rows of y1q (on int8 rows
//     ldmatrix.b16 gives the s8 k32 A layout as it is), B the tap's (mid, mid)
//     tile.
//   conv3: A is conv2's accumulators dequantized, biased, ReLU'd, rounded and
//     requantized in registers, so y2 never touches shared memory. A thread
//     holds channels {2t, 2t+1, 2t+8, 2t+9, +16 ...} (t = lane % 4) of each
//     32-column group of the s32 accumulators, where the s8 k32 A fragment
//     wants K positions {4t..4t+3, 4t+16..4t+19}: the wrapper permutes w3's
//     K by the bijection between the two (ops/fused_bottleneck_int8.py:
//     k_order), so the permutation costs nothing here. conv3's sums stay
//     below 2^22 and are converted to fp32 by the same add, without a
//     conversion instruction. The columns of w3 and wd are in
//     ops/fused_bottleneck.py:channel_order: a thread's eight values are
//     eight consecutive channels, read (identity residual, a chunk ahead) and
//     written as 16-byte vectors. The projection's A is the tile's own 128
//     pixels, each warpgroup quantizing its 64 into its rows of xq.
//   Weights: every weight is an (N, K) K-major matrix of units laid side by
//     side along K (w1: C; w2: the nine taps, mid each; w3: the conv3 chunks,
//     mid each; wd: per conv3 chunk, C), cut into 128-byte (128-value) panels,
//     128-byte swizzled, K zero-padded. The resident form keeps w1, w2, w3 in
//     shared memory for the block's life (layer1: 72 KB, 5 halo stages); the
//     streamed form sends, with each unit, the panel that holds it (layer2's
//     272 KB cannot stay: 4 stages of a halo box and a w1 panel). The
//     projection's wd streams with the tile's own 128 pixels, per conv3 chunk
//     and 64 channels. A stage that carries a weight panel an ss product
//     reads is released a box later, once those products are done. The form
//     follows from the widths: resident where the weights leave room for 3
//     stages.
//   The per-channel dequantize vectors and biases are copied into shared
//     memory once per block, laid out as the epilogues read them
//     (stage_vectors).
//
// Built with -DBOTTLENECK_PROFILE (dir_tpu_torch/profile_kernels.py), one
// consumer thread and the producer sum clock() per phase; the main path's
// build never sets it. (At mid 128 the sums' registers make ptxas serialize
// the instrumented build's wgmma, so its products read slower there.)
//
// C interface (bound with ctypes): fused_bottleneck_int8_bf16 launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "wgmma_s8.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;                          // output rows of a tile
constexpr int TW = 16;                         // output columns of a tile
constexpr int HALO_W = TW + 2;                 // 18
constexpr int HALO = (TH + 2) * HALO_W;        // 180 halo pixels
constexpr int HALO_ROWS = 192;                 // conv1's three 64-row wgmma tiles
constexpr int BOX_H = TH + 3;                  // the TMA box: 18 x 11 = 198 >= 192 rows
constexpr int KC = 64;                         // channels of a halo box: one 128-byte bf16 row
constexpr int ROW = 128;                       // bytes of a box row or a weight panel row
constexpr int PANEL_K = 128;                   // int8 K values of a weight panel row
constexpr int X_BYTES = HALO_W * BOX_H * ROW;  // 25,344 bytes a halo box delivers
constexpr int X_SLOT = 25 * 1024;              // ... rounded up to the 1024-byte swizzle atom
constexpr int XC_BYTES = TH * TW * ROW;        // 16,384: the tile's own pixels, one box
constexpr int MAX_STAGES = 6;
constexpr int MIN_RESIDENT_STAGES = 3;
constexpr int BAR_BYTES = 1024;                // the mbarriers, ahead of the ring
constexpr int MAX_SMEM = 232448;               // H100: 227 KB of dynamic shared memory per block
constexpr int Y1_SKEW = 16;                    // y1q row padding (bytes): ldmatrix rows in distinct banks
constexpr float RINT_MAGIC = 12582912.0f;      // 1.5 * 2^23

// Everything the kernel reads beside the two tensor maps.
struct Params {
  const bf16* x;                  // (B, H, W, C), for the identity residual
  const unsigned char* image;     // the int8 weight image (ops/fused_bottleneck_int8.py)
  const float* inv;               // (3,): 1 / the activation scales
  const float* m1;
  const float* b1;
  const float* m2;
  const float* b2;
  const float* m3;
  const float* b3;
  const float* md;
  const float* bd;
  bf16* out;                      // (B, H, W, O)
  int H, W, C, O;
  int ntx, nty, tiles;
  int nk;                         // conv1's boxes of 64 input channels
  int nj;                         // conv3's chunks of mid output channels
  int ncp;                        // 128-wide K panels of w1 (and of wd per chunk)
  int has_down;
  int stages;
  int stage_bytes;
  int w2_off, w3_off, wd_off;     // byte offsets of the images (w1's is 0)
};

// Widths and image sizes that follow from mid (M).
template <int M>
struct Shape {
  static constexpr int N1 = M / 2;              // conv1 columns of one consumer warpgroup
  static constexpr int KS = M / 32;             // k32 steps of conv2 and conv3
  static constexpr int N3 = M;                  // output channels of a conv3 chunk
  static constexpr int LDY = M + Y1_SKEW;       // bytes of a y1q row
  // the quantized halo box, two boxes to a 128-byte row, then y1q in its place
  static constexpr int XQ_BYTES = round_up(LDY > ROW ? HALO_ROWS * LDY : HALO_ROWS * ROW, 1024);
  static constexpr int W1P = M * ROW;           // bytes of one w1 panel
  static constexpr int W2P = M * ROW;           // bytes of one w2 panel
  static constexpr int W2_BYTES = round_up(9 * M, PANEL_K) * M;
  static constexpr int W3P = N3 * ROW;          // bytes of one w3 (or wd) panel
};

// The descriptor of the k32 step at K offset k of a weight of `rows` rows
// whose panels start at `base`.
__device__ __forceinline__ uint64_t panel_desc(const unsigned char* base, int rows, int k) {
  return desc_sw128(base + (k / PANEL_K) * rows * ROW) + ((k % PANEL_K) / 32) * 2;
}

// clip(rint(v * inv), +-127) as a byte in the low 8 bits: clipped in fp32,
// then rounded half to even by an fp32 add of 1.5 * 2^23, whose sum lies in
// [2^23, 2^24) (spacing 1) and holds the integer, two's complement, in its
// low byte.
__device__ __forceinline__ uint32_t q_byte(float v, float inv) {
  const float f = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(f, RINT_MAGIC));
}

// Four bf16 values, the low and high halves of u and then of v, quantized
// and packed low byte first.
__device__ __forceinline__ uint32_t quant4(uint32_t u, uint32_t v, float inv) {
  const uint32_t b0 = q_byte(__uint_as_float(u << 16), inv);
  const uint32_t b1 = q_byte(__uint_as_float(u & 0xffff0000u), inv);
  const uint32_t b2 = q_byte(__uint_as_float(v << 16), inv);
  const uint32_t b3 = q_byte(__uint_as_float(v & 0xffff0000u), inv);
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// s32 -> fp32, times m, plus b (two roundings), rounded to bf16.
__device__ __forceinline__ float dequant_bf16(int acc, float m, float b) {
  return __bfloat162float(
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc), m), b)));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&t);
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

// Eight floats from shared memory, as two 16-byte loads.
__device__ __forceinline__ void load8s(float* v, const float* p) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(p + 4);
}

// Quantizes rows [r0, r0 + rows) of a swizzled bf16 box (64 channels in
// 128-byte rows, the 16-byte chunk c of row r at chunk c ^ (r % 8)) into half
// h (bytes 64 h .. 64 h + 63) of the same rows of xq, int8 rows of 128 bytes
// swizzled the same way: the K-major layout an ss wgmma reads. `n` threads
// share the work from thread index `tid`, 8 channels at a time.
__device__ __forceinline__ void quantize_box(unsigned char* xq, const unsigned char* box, int r0,
                                             int rows, int h, float inv, int tid, int n) {
  for (int u = tid; u < rows * 8; u += n) {
    const int r = r0 + u / 8;
    const int c = u % 8;
    const uint4 v = *reinterpret_cast<const uint4*>(box + r * ROW + ((c ^ (r & 7)) << 4));
    *reinterpret_cast<uint2*>(xq + r * ROW + (((4 * h + c / 2) ^ (r & 7)) << 4) + (c & 1) * 8) =
        make_uint2(quant4(v.x, v.y, inv), quant4(v.z, v.w, inv));
  }
}

// The per-channel vectors into shared memory, by every thread of the block:
// read there, they do not wait on L1 misses behind the residual's loads (read
// with __ldg after a wgmma wait, they did). Each is laid out as its readers
// take it, at offsets from one base: per channel pair (m1, m1, b1, b1) and
// (m2, m2, b2, b2) from 0 and 2 M; per 8 output channels (m3 x 8, b3 x 8[,
// md x 8, bd x 8]) from 4 M.
template <int M>
__device__ __forceinline__ void stage_vectors(float* vec, const Params& p) {
  const int per8 = p.has_down ? 32 : 16;
  for (int i = threadIdx.x; i < M; i += THREADS) {
    const int at = 2 * (i & ~1) + (i & 1);
    vec[at] = p.m1[i];
    vec[at + 2] = p.b1[i];
    vec[2 * M + at] = p.m2[i];
    vec[2 * M + at + 2] = p.b2[i];
  }
  for (int i = threadIdx.x; i < p.O; i += THREADS) {
    const int at = 4 * M + (i / 8) * per8 + i % 8;
    vec[at] = p.m3[i];
    vec[at + 8] = p.b3[i];
    if (p.has_down) {
      vec[at + 16] = p.md[i];
      vec[at + 24] = p.bd[i];
    }
  }
}

// The producer: one thread issues every copy, in the order the consumers use
// them, through the ring of stages. Per tile: conv1's nk boxes (plus, when
// streamed, the w1 panel that holds the box's channels); when streamed, the
// panel of each of the nine w2 taps; then per conv3 chunk j its w3 panel when
// streamed, and with the projection nk pairs (the tile's own pixels, the wd
// panel of those channels).
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
      if (!RESIDENT)
        bulk_copy(st + X_SLOT, p.image + (kc * KC / PANEL_K) * S::W1P, S::W1P, bar);
      PROF(1)
    }
    if (!RESIDENT) {
      for (int t = 0; t < 9; ++t) {
        acquire(S::W2P);
        bulk_copy(st, p.image + p.w2_off + (t * M / PANEL_K) * S::W2P, S::W2P, bar);
        PROF(1)
      }
    }
    for (int j = 0; j < p.nj; ++j) {
      if (!RESIDENT) {
        acquire(S::W3P);
        bulk_copy(st, p.image + p.w3_off + (j * M / PANEL_K) * S::W3P, S::W3P, bar);
        PROF(1)
      }
      if (p.has_down) {
        for (int kc = 0; kc < p.nk; ++kc) {
          acquire(XC_BYTES + S::W3P);
          tma_box(st, tm_center, bar, kc * KC, tx * TW, ty * TH, n);
          bulk_copy(st + XC_BYTES,
                    p.image + p.wd_off + (j * p.ncp + kc * KC / PANEL_K) * S::W3P, S::W3P,
                    bar);
          PROF(1)
        }
      }
    }
    PROF_COUNT(15)
  }
  PROF_FLUSH(16)
}

// The two consumer warpgroups. Warpgroup wg computes conv1's mid columns
// [wg * M/2, (wg + 1) * M/2) over all 192 halo rows, then conv2 and conv3 for
// its own 64 output pixels: output rows 4 wg .. 4 wg + 3, one per warp.
template <int M, bool RESIDENT>
__device__ __forceinline__ void consume(const Params& p, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, uint64_t* wbar,
                                        const unsigned char* wres, unsigned char* xq,
                                        const float* vec) {
  using S = Shape<M>;
  constexpr int N1 = S::N1, N3 = S::N3, KS = S::KS, LDY = S::LDY;
  unsigned char* y1q = xq;                   // y1q takes xq's place after conv1
  PROF_DECL
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int oy = 4 * wg + warp;              // this warp's output row of the tile
  const float inv0 = __ldg(p.inv), inv1 = __ldg(p.inv + 1), inv2 = __ldg(p.inv + 2);
  uint32_t it = 0;
  auto wait_stage = [&]() -> int {
    const int s = (int)(it % (uint32_t)p.stages);
    mbar_wait(&full[s], (it / (uint32_t)p.stages) & 1);
    ++it;
    return s;
  };
  // each consumer warp releases a stage once it and its products have read it
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  if (RESIDENT) mbar_wait(wbar, 0);
  PROF(0)

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int tx0 = (tile % p.ntx) * TW;
    const int ty0 = ((tile / p.ntx) % p.nty) * TH;
    const int n = tile / (p.ntx * p.nty);

    // conv1: acc1[i] is halo rows 64 i .. 64 i + 63, N1 mid columns. Both
    // warpgroups quantize the box into half kc % 2 of xq, each value once;
    // the products of a box run while the next box is quantized. Before a
    // half is written again, both warpgroups have waited for the products
    // that read it (the wait before the barrier), and before the first box
    // both have finished reading the last tile's y1q in xq's place.
    int acc1[3][N1 / 2];
#pragma unroll
    for (int i = 0; i < 3; ++i) zero(acc1[i]);
    // A stage that carries a w1 panel (streamed) is released once the
    // products that read it are done, a box later.
    consumers_sync();
    int prev = -1;
    for (int kc = 0; kc < p.nk; ++kc) {
      const int s = wait_stage();
      PROF(1)
      const unsigned char* st = ring + s * p.stage_bytes;
      const unsigned char* w1 = (RESIDENT ? wres : st + X_SLOT - (kc * KC / PANEL_K) * S::W1P) +
                                wg * N1 * ROW;
      quantize_box(xq, st, 0, HALO_ROWS, kc % 2, inv0, threadIdx.x, CONSUMERS * 128);
      if (RESIDENT) release(s);
      fence_proxy_async();
      wg_wait_all();
      if (!RESIDENT && prev >= 0) release(prev);
      prev = s;
      consumers_sync();
      wg_fence();
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          WgmmaS8<N1>::ss(acc1[i], desc_sw128(xq + 64 * i * ROW) + (2 * (kc % 2) + h) * 2,
                          panel_desc(w1, M, kc * KC + 32 * h));
      wg_commit();
      PROF(2)
    }
    wg_wait_all();
#pragma unroll
    for (int i = 0; i < 3; ++i) fence_regs(acc1[i]);
    if (!RESIDENT) release(prev);

    // y1q = q(relu(bf16(conv1 * m1 + b1)), inv1) into shared memory, 0
    // outside the image (conv2's zero padding) and in the padding rows. The
    // barrier before: the other warpgroup's products have read xq.
    consumers_sync();
#pragma unroll
    for (int jn = 0; jn < N1 / 8; ++jn) {
      const int ch = wg * N1 + 8 * jn + 2 * tig;
      const float4 mb = *reinterpret_cast<const float4*>(vec + 2 * ch);
      const float2 m = make_float2(mb.x, mb.y), b = make_float2(mb.z, mb.w);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 64 * i + 16 * warp + g + 8 * hf;
          const int gy = ty0 - 1 + r / HALO_W;
          const int gx = tx0 - 1 + r % HALO_W;
          const bool inside = r < HALO && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
          const uint32_t q0 =
              q_byte(fmaxf(dequant_bf16(acc1[i][4 * jn + 2 * hf], m.x, b.x), 0.0f), inv1);
          const uint32_t q1 =
              q_byte(fmaxf(dequant_bf16(acc1[i][4 * jn + 2 * hf + 1], m.y, b.y), 0.0f), inv1);
          *reinterpret_cast<uint16_t*>(y1q + r * LDY + ch) =
              inside ? (uint16_t)__byte_perm(q0, q1, 0x0040) : (uint16_t)0;
        }
      }
    }
    consumers_sync();
    PROF(3)

    // conv2: nine taps; tap (dy, dx) of output row oy reads the 16 halo rows
    // from (oy + dy) * 18 + dx, as A registers loaded by ldmatrix
    int acc2[M / 2];
    zero(acc2);
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int akof = (lane >> 4) * 16;
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3;
      const int dx = t - dy * 3;
      int s = 0;
      const unsigned char* w2;
      if (RESIDENT) {
        w2 = wres + p.w2_off;
      } else {
        s = wait_stage();
        w2 = ring + s * p.stage_bytes - (t * M / PANEL_K) * S::W2P;
      }
      PROF(4)
      const unsigned char* a0 = y1q + ((oy + dy) * HALO_W + dx + arow) * LDY + akof;
      uint32_t a[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(a[kk], a0 + kk * 32);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) WgmmaS8<M>::rs(acc2, a[kk], panel_desc(w2, M, t * M + 32 * kk));
      wg_commit();
      wg_wait_all();
      fence_regs(acc2);
      if (!RESIDENT) release(s);
      PROF(5)
    }

    // y2 = q(relu(bf16(conv2 * m2 + b2)), inv2) stays in registers as conv3's
    // A: of the 32 columns of step kk, a thread holds columns 8 jn + 2 tig + e
    // (jn = 4 kk .. 4 kk + 3) of rows g and g + 8; a0 takes jn 4 kk and 4 kk + 1
    // of row g, a1 those of row g + 8, a2 and a3 jn 4 kk + 2 and 4 kk + 3.
    uint32_t y2[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qv[4][4];                     // [jn - 4 kk][2 hf + e]
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jn = 4 * kk + jj;
        const int ch = 8 * jn + 2 * tig;
        const float4 mb = *reinterpret_cast<const float4*>(vec + 2 * M + 2 * ch);
        const float2 m = make_float2(mb.x, mb.y), b = make_float2(mb.z, mb.w);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          qv[jj][2 * hf] = q_byte(fmaxf(dequant_bf16(acc2[4 * jn + 2 * hf], m.x, b.x), 0.0f), inv2);
          qv[jj][2 * hf + 1] =
              q_byte(fmaxf(dequant_bf16(acc2[4 * jn + 2 * hf + 1], m.y, b.y), 0.0f), inv2);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)        // h: jn pair (0: jj 0, 1; 1: jj 2, 3)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          y2[kk][2 * h + hf] = __byte_perm(__byte_perm(qv[2 * h][2 * hf], qv[2 * h][2 * hf + 1], 0x0040),
                                           __byte_perm(qv[2 * h + 1][2 * hf], qv[2 * h + 1][2 * hf + 1], 0x0040),
                                           0x5410);
    }
    PROF(6)

    // conv3 and the residual, N3 output channels at a time. The two residual
    // forms are two code paths, so that neither keeps the other's registers.
    bf16* outn = p.out + (size_t)n * p.H * p.W * p.O;
    const bf16* xn = p.x + (size_t)n * p.H * p.W * p.C;
    const int gy = ty0 + oy;
    auto conv3 = [&](auto down) {
      constexpr bool DOWN = decltype(down)::value;
      // the projection writes xq: the other warpgroup's conv2 has read y1q
      if constexpr (DOWN) consumers_sync();
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
      uint4 resv[DOWN ? 1 : N3 / 32][2], resn[DOWN ? 1 : N3 / 32][2];
      if constexpr (!DOWN) load_residual(0, resv);
      for (int j = 0; j < p.nj; ++j) {
        int acc3[N3 / 2];
        zero(acc3);
        int s = 0;
        const unsigned char* w3;
        if (RESIDENT) {
          w3 = wres + p.w3_off;
        } else {
          s = wait_stage();
          w3 = ring + s * p.stage_bytes - (j * M / PANEL_K) * S::W3P;
        }
        PROF(7)
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          WgmmaS8<N3>::rs(acc3, y2[kk], panel_desc(w3, N3, j * M + 32 * kk));
        wg_commit();
        if constexpr (!DOWN) load_residual(j + 1, resn);
        wg_wait_all();
        fence_regs(acc3);
        if (!RESIDENT) release(s);
        PROF(8)
        int accd[DOWN ? N3 / 2 : 1];
        if constexpr (DOWN) {
          // the projection: A is the tile's own pixels quantized as for
          // conv1, each warpgroup its own 64 (its output rows) into its own
          // rows of xq; a stage (it carries a wd panel) is released once the
          // products that read it are done, a box later
          zero(accd);
          int prevd = -1;
          for (int kc = 0; kc < p.nk; ++kc) {
            const int sd = wait_stage();
            PROF(7)
            const unsigned char* st = ring + sd * p.stage_bytes;
            const unsigned char* wdp = st + XC_BYTES - (kc * KC / PANEL_K) * S::W3P;
            quantize_box(xq, st, 64 * wg, 64, kc % 2, inv0, threadIdx.x % 128, 128);
            fence_proxy_async();
            wg_wait_all();
            if (prevd >= 0) release(prevd);
            prevd = sd;
            warpgroup_sync(wg);
            wg_fence();
#pragma unroll
            for (int h = 0; h < 2; ++h)
              WgmmaS8<N3>::ss(accd, desc_sw128(xq + 64 * wg * ROW) + (2 * (kc % 2) + h) * 2,
                              panel_desc(wdp, N3, kc * KC + 32 * h));
            wg_commit();
            PROF(8)
          }
          wg_wait_all();
          fence_regs(accd);
          release(prevd);
        }

#pragma unroll
        for (int q = 0; q < N3 / 32; ++q) {
          const int ch = j * N3 + 32 * q + 8 * tig;
          if (ch < p.O) {
            float m3c[8], b3c[8], mdc[8], bdc[8];
            const float* v8 = vec + 4 * M + (ch / 8) * (DOWN ? 32 : 16);
            load8s(m3c, v8);
            load8s(b3c, v8 + 8);
            if constexpr (DOWN) {
              load8s(mdc, v8 + 16);
              load8s(bdc, v8 + 24);
            }
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int gx = tx0 + g + 8 * hf;
              if (gy < p.H && gx < p.W) {
                float y3[8], res[8];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const int a = 4 * (4 * q + jj) + 2 * hf + e;
                    const int c = 2 * jj + e;
                    y3[c] = dequant_bf16(acc3[a], m3c[c], b3c[c]);
                    if constexpr (DOWN) res[c] = dequant_bf16(accd[a], mdc[c], bdc[c]);
                  }
                if constexpr (!DOWN) unpack8(resv[q][hf], res);
                // the add runs in bf16: the sum is rounded (by the pack), and
                // relu commutes with the rounding
                uint4 o;
                uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  ow[k] = pack2(fmaxf(__fadd_rn(y3[2 * k], res[2 * k]), 0.0f),
                                fmaxf(__fadd_rn(y3[2 * k + 1], res[2 * k + 1]), 0.0f));
                *reinterpret_cast<uint4*>(outn + ((size_t)gy * p.W + gx) * p.O + ch) = o;
              }
            }
          }
        }
        if constexpr (!DOWN) {
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
    fused_bottleneck_int8_kernel(const __grid_constant__ CUtensorMap tm_halo,
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
  unsigned char* xq = wres + (RESIDENT ? p.wd_off : 0);
  float* vec = reinterpret_cast<float*>(xq + Shape<M>::XQ_BYTES);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_vectors<M>(vec, p);
  __syncthreads();

  // registers move from the producer warpgroup to the consumers
  if (threadIdx.x >= CONSUMERS * 128) {
    producer_registers();
    if (threadIdx.x == CONSUMERS * 128)
      produce<M, RESIDENT>(&tm_halo, &tm_center, p, ring, full, empty, wbar, wres);
  } else {
    consumer_registers();
    consume<M, RESIDENT>(p, ring, full, empty, wbar, wres, xq, vec);
  }
}

// Bytes of the weight image, in the order w1, w2, w3, wd, and the ring's
// stage of each form.
struct Layout {
  int w2_off, w3_off, wd_off, end;
  int nk, nj, ncp;
  bool resident;
  int stages, stage_bytes, smem;
};

template <int M>
int stage_bytes(int has_down, bool resident) {
  using S = Shape<M>;
  int stage = X_SLOT;
  if (has_down) stage = std::max(stage, XC_BYTES + S::W3P);
  if (!resident) stage = std::max({stage, X_SLOT + S::W1P, S::W2P, S::W3P});
  return round_up(stage, 1024);
}

// Dynamic shared memory of a block of either form with `stages` stages: the
// ring, the resident weights, xq (then y1q) and the per-channel vectors (m1,
// b1, m2, b2; m3, b3 and md, bd of the nj chunks).
template <int M>
int smem_bytes(int wd_off, int nj, int has_down, bool resident, int stages) {
  return 1024 + BAR_BYTES + stages * stage_bytes<M>(has_down, resident) +
         (resident ? wd_off : 0) + Shape<M>::XQ_BYTES +
         4 * (4 * M + 2 * nj * M * (1 + has_down));
}

// The most stages (2 .. MAX_STAGES) that fit, or 0.
template <int M>
int stages_that_fit(int wd_off, int nj, int has_down, bool resident) {
  for (int stages = MAX_STAGES; stages >= 2; --stages)
    if (smem_bytes<M>(wd_off, nj, has_down, resident, stages) <= MAX_SMEM) return stages;
  return 0;
}

template <int M>
Layout layout(int C, int O, int has_down) {
  using S = Shape<M>;
  Layout l;
  l.nk = (C + KC - 1) / KC;
  l.ncp = (C + PANEL_K - 1) / PANEL_K;
  l.nj = round_up(O, S::N3) / S::N3;
  l.w2_off = l.ncp * S::W1P;
  l.w3_off = l.w2_off + S::W2_BYTES;
  l.wd_off = l.w3_off + round_up(l.nj * M, PANEL_K) / PANEL_K * S::W3P;
  l.end = l.wd_off + (has_down ? l.nj * l.ncp * S::W3P : 0);
  // resident where w1, w2 and w3 leave room for MIN_RESIDENT_STAGES stages
  l.resident = stages_that_fit<M>(l.wd_off, l.nj, has_down, true) >= MIN_RESIDENT_STAGES;
  l.stages = stages_that_fit<M>(l.wd_off, l.nj, has_down, l.resident);
  l.stage_bytes = stage_bytes<M>(has_down, l.resident);
  l.smem = smem_bytes<M>(l.wd_off, l.nj, has_down, l.resident, std::max(l.stages, 2));
  return l;
}

template <int M, bool RESIDENT>
int launch(const Layout& l, const void* x, const void* image, const float* const* vec, void* out,
           int B, int H, int W, int C, int O, int has_down, void* stream) {
  CUtensorMap tm_halo, tm_center;
  if (!encode_nhwc(&tm_halo, x, B, H, W, C, HALO_W, BOX_H) ||
      !encode_nhwc(&tm_center, x, B, H, W, C, TW, TH))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = (const bf16*)x;
  p.image = (const unsigned char*)image;
  p.inv = vec[0];
  p.m1 = vec[1];
  p.b1 = vec[2];
  p.m2 = vec[3];
  p.b2 = vec[4];
  p.m3 = vec[5];
  p.b3 = vec[6];
  p.md = vec[7];
  p.bd = vec[8];
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
  p.ncp = l.ncp;
  p.has_down = has_down;
  p.stages = l.stages;
  p.stage_bytes = l.stage_bytes;
  p.w2_off = l.w2_off;
  p.w3_off = l.w3_off;
  p.wd_off = l.wd_off;
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_int8_kernel<M, RESIDENT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block an SM, each walking tiles blockIdx.x, + gridDim.x, ...
  const int grid = std::min(p.tiles, sm_count());
  fused_bottleneck_int8_kernel<M, RESIDENT><<<grid, THREADS, l.smem, (cudaStream_t)stream>>>(
      tm_halo, tm_center, p);
  return (int)cudaGetLastError();
}

template <int M>
int dispatch(const void* x, const void* image, const float* const* vec, void* out, int B, int H,
             int W, int C, int O, int has_down, void* stream) {
  const Layout l = layout<M>(C, O, has_down);
  if (l.stages < 2) return (int)cudaErrorInvalidValue;
  return l.resident
             ? launch<M, true>(l, x, image, vec, out, B, H, W, C, O, has_down, stream)
             : launch<M, false>(l, x, image, vec, out, B, H, W, C, O, has_down, stream);
}

bool takes(int C, int M, int O, int has_down) {
  return C > 0 && O > 0 && C % 32 == 0 && O % 32 == 0 && (M == 32 || M == 64 || M == 128) &&
         (has_down || O == C);
}

Layout layout_of(int C, int M, int O, int has_down) {
  switch (M) {
    case 32: return layout<32>(C, O, has_down);
    case 64: return layout<64>(C, O, has_down);
    default: return layout<128>(C, O, has_down);
  }
}

}  // namespace

// Bytes of the weight image fused_bottleneck_int8_bf16 reads for these widths
// (-1 for widths it does not take).
extern "C" int fused_bottleneck_int8_image_bytes(int C, int M, int O, int has_down) {
  if (!takes(C, M, O, has_down)) return -1;
  return layout_of(C, M, O, has_down).end;
}

// The dynamic shared memory a block takes for these widths, in the form they
// select; the second argument receives 1 for the resident form, 0 for the
// streamed one, and the third its stages (-1 for widths it does not take).
extern "C" int fused_bottleneck_int8_smem_bytes(int C, int M, int O, int has_down,
                                                int* resident, int* stages) {
  if (!takes(C, M, O, has_down)) return -1;
  const Layout l = layout_of(C, M, O, has_down);
  *resident = l.resident;
  *stages = l.stages;
  return l.smem;
}

// x (B, H, W, C) bf16; image: the int8 weight image of kernel_operands; inv
// (3,) and m1, b1, m2, b2 (M,), m3, b3, md, bd (O,) fp32 in channel order (md,
// bd null without the projection); out (B, H, W, O) bf16. Launches on the
// given stream, allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for shapes it does not take.
extern "C" int fused_bottleneck_int8_bf16(const void* x, const void* image, const void* inv,
                                          const void* m1, const void* b1, const void* m2,
                                          const void* b2, const void* m3, const void* b3,
                                          const void* md, const void* bd, void* out, int B,
                                          int H, int W, int C, int M, int O, int has_down,
                                          void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || !takes(C, M, O, has_down))
    return (int)cudaErrorInvalidValue;
  const float* vec[9] = {(const float*)inv, (const float*)m1, (const float*)b1,
                         (const float*)m2,  (const float*)b2, (const float*)m3,
                         (const float*)b3,  (const float*)md, (const float*)bd};
  switch (M) {
    case 32: return dispatch<32>(x, image, vec, out, B, H, W, C, O, has_down, stream);
    case 64: return dispatch<64>(x, image, vec, out, B, H, W, C, O, has_down, stream);
    default: return dispatch<128>(x, image, vec, out, B, H, W, C, O, has_down, stream);
  }
}

extern "C" const char* fused_bottleneck_int8_error_string(int code) {
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
