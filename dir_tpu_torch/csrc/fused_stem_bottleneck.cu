// Stem BN + ReLU + 3x3/2 max pool + the projection bottleneck (layer1_0) in one
// kernel, fed by the raw stem-conv output, bf16 in and out, for Hopper
// (sm_90a). Kernel K4.
//
// Replaces dir_tpu/ops/pallas_bottleneck.py:_stem_kernel (reached by
// fused_stem_bottleneck). With the BNs folded beforehand it computes
//   a      = relu(bf16(bf16(x * bf16(g1)) + bf16(t1)))   the affine runs in bf16
//   pooled = maxpool3x3, stride 2, zero padding 1 (exact: a >= 0 and every
//            window holds a real pixel)
//   out    = the projection bottleneck of fused_bottleneck.cu on pooled:
//            relu(bf16(conv3(conv2(conv1))) + bf16(pooled . wd + bd))
// The TPU kernel's paired-W input layout and its row bands serve its lanes and
// its fast memory and are not carried over: x is plain NHWC (B, 2H, 2W, C).
//
// What bounds it on an H100: at the stem's shape, x (B, 128, 128, 64) ->
// (B, 64, 64, 256), mid 64, input and output are B*(128*128*64 + 64*64*256)*2
// bytes (1.07 GB at B = 256, 0.32 ms at 3.35 TB/s) against
// 2*B*4096*(64*64 + 9*64*64 + 64*256 + 64*256) = 146 GFLOP (0.15 ms at 989
// TFLOP/s): device-memory bytes.
//
// What the design does about it: the activated map, the pooled map and the
// block's intermediates never reach device memory. A block owns an 8x16 tile
// of pooled pixels; each thread makes eight channels of one pixel of the
// tile's 10x18 pooled halo from its nine raw pixels (16-byte loads, the raw
// window's overlap served by L1/L2: 2.25 loads per raw pixel, and the halo's
// 1.4x), writes it into the block's input halo in shared memory, and the block
// goes on with WMMA bf16 fragments (fused_stem_bottleneck_kernel<M> of
// bottleneck_tile.cuh). A pooled halo pixel outside the pooled map is conv2's
// zero padding.
//
// C interface (bound with ctypes): fused_stem_bottleneck_bf16 launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).

#include "bottleneck_tile.cuh"

namespace {

// K4 is fused_stem_bottleneck_kernel<M> of bottleneck_tile.cuh.
template <int M>
int launch(const void* x, const void* g1, const void* t1, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* w3, const void* b3, const void* wd,
           const void* bd, void* out, int B, int H, int W, int C, int O, int smem,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_bottleneck_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fused_stem_bottleneck_kernel<M><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)g1, (const float*)t1, (const bf16*)w1,
      (const float*)b1, (const bf16*)w2, (const float*)b2, (const bf16*)w3,
      (const float*)b3, (const bf16*)wd, (const float*)bd, (bf16*)out, H, W, C, O,
      1, wbuf_elems(C, M, O));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_stem_bottleneck_smem_bytes(int C, int M, int O) {
  return tile_smem_bytes(C, M, O);
}

// x (B, 2H, 2W, C) bf16; g1, t1 (C,) fp32; the folded weights as for
// fused_bottleneck_bf16 with the projection; out (B, H, W, O) bf16. H and W
// are the pooled map's.
extern "C" int fused_stem_bottleneck_bf16(
    const void* x, const void* g1, const void* t1, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* w3, const void* b3, const void* wd,
    const void* bd, void* out, int B, int H, int W, int C, int M, int O, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % 16 ||
      O % 16 || (M != 16 && M != 32 && M != 64 && M != 128))
    return (int)cudaErrorInvalidValue;
  const int smem = tile_smem_bytes(C, M, O);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  switch (M) {
    case 16:
      return launch<16>(x, g1, t1, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                        smem, stream);
    case 32:
      return launch<32>(x, g1, t1, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                        smem, stream);
    case 64:
      return launch<64>(x, g1, t1, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                        smem, stream);
    default:
      return launch<128>(x, g1, t1, w1, b1, w2, b2, w3, b3, wd, bd, out, B, H, W, C, O,
                         smem, stream);
  }
}

extern "C" const char* fused_stem_bottleneck_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
