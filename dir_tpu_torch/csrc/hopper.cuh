// The Hopper plumbing of the persistent, warp-specialised bottleneck kernels
// (fused_bottleneck.cu: K1, K2; fused_bottleneck_int8.cu: K3;
// fused_stem_bottleneck.cu: K4): their roles, mbarriers, TMA box, prefetch
// and bulk copies, wgmma descriptors and fences, and the host-side
// tensor-map encoding of NHWC activations.
//
// Roles: two consumer warpgroups do the math; one thread of a producer
// warpgroup issues every copy into a ring of stages, each guarded by a full
// and an empty mbarrier. Every wait is bounded: a pipeline fault traps, so a
// launch fails instead of hanging.
//
// Built with -DBOTTLENECK_PROFILE, PROF_DECL / PROF(slot) / PROF_COUNT(slot) /
// PROF_FLUSH(base) sum clock() per phase into g_prof (slots 0-15 one
// consumer thread, 16-31 the producer thread); the main path's build never
// sets it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 2;                   // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128; // plus one producer warpgroup
constexpr long long WAIT_LIMIT = 1ll << 32;    // cycles (about 2 s) before a wait traps

#ifdef BOTTLENECK_PROFILE
// Sums of 32-bit clock() differences (a thread's phase sums stay far below
// 2^32 cycles) in registers, flushed once by the thread that kept them.
__device__ unsigned long long g_prof[32];
#define PROF_DECL                          \
  unsigned int prof_t = (unsigned)clock(); \
  unsigned int prof_acc[16] = {};
#define PROF(slot)                             \
  {                                            \
    const unsigned int t_ = (unsigned)clock(); \
    prof_acc[slot] += t_ - prof_t;             \
    prof_t = t_;                               \
  }
#define PROF_COUNT(slot) prof_acc[slot] += 1;
#define PROF_FLUSH(base)           \
  for (int i_ = 0; i_ < 16; ++i_) \
    atomicAdd(&g_prof[(base) + i_], (unsigned long long)prof_acc[i_]);
#else
#define PROF_DECL
#define PROF(slot)
#define PROF_COUNT(slot)
#define PROF_FLUSH(base)
#endif

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_test(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Wait for the completion of the barrier's phase of this parity. A wait that
// outlasts WAIT_LIMIT cycles is a pipeline fault: it traps, so the launch
// fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_test(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_test(addr, parity))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}

// A (64 channels x 18 x 11, 16 x 8 or 37 x 5 pixels) box of x through the
// tensor map, 128-byte swizzled, filled (zero or NaN) where it leaves the
// tensor.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                        int x, int y, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(x), "r"(y), "r"(n)
      : "memory");
}

// The same box, prefetched into L2 only.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map, int c, int x, int y, int n) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.4d.L2.global.tile [%0, {%1, %2, %3, %4}];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(x), "r"(y), "r"(n)
      : "memory");
}

// Contiguous bytes (a multiple of 16) from device memory.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte-swizzled rows (8-row
// atoms of 1024 bytes, the layout TMA's 128-byte swizzle writes); one step of
// 32 bytes further along K (k16 of bf16, k32 of int8) is + 2.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's products are in
// flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait_all() { wg_wait<0>(); }

// Keep the compiler from moving reads of accumulators across the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <typename T, int R>
__device__ __forceinline__ void zero(T (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = T(0);
}

// The consumer warpgroups' own barrier (id 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// One consumer warpgroup's own barrier (id 2 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Makes this thread's shared-memory stores visible to the async proxy that
// wgmma reads its shared operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8-row x 16-byte matrices from shared memory, one row address a lane
// (lanes 8i..8i+7 give matrix i); register i holds, of matrix i, row lane/4,
// bytes (lane%4)*4..+3.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Registers move from the producer warpgroup to the consumers: what .inc
// asks for must be what .dec gives back, (168 - 56) * 128 = (224 - 168) *
// 256, or .inc waits for ever.
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, from the libcuda the runtime loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A map over NHWC bf16 x with a (64 channels, bw, bh, 1) box, 128-byte
// swizzle and zero fill outside the tensor (NaN fill with nan_fill). Host
// work only.
bool encode_nhwc(CUtensorMap* map, const void* x, int B, int H, int W, int C, int bw,
                 int bh, bool nan_fill = false) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            nan_fill ? CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA
                     : CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace
