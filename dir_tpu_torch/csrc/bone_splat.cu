// Bone-feature splat (kernel K5), bf16 or fp32 features, for Hopper (sm_90a).
//
// Replaces dir_tpu/ops/pallas_bone_splat.py:bone_splat_pallas (Pallas
// `_kernel`). Per sample, for every pixel centre p of an S x S map (x fastest)
// and each of the 20 hand bones k = (PARENT[k] -> CHILD[k]):
//   seg_dist = distance from p to the bone's segment, in pixels, in fp32
//   mask     = seg_dist < distance  and  the bone has a length
//   w_a, w_b = mask ? 1 - |p - a| / (|p - a| + |p - b|),  1 - |p - b| / (...) : 0
//   out[p, k*C + i] = T(T(w_a) * feat[a, i] + T(w_b) * feat[b, i])
// where T is the feature type: the weights are rounded to it before the
// multiply, the two products are summed in fp32, and the sum is rounded once.
//
// The TPU kernel folds the last line into a selector matmul, because Mosaic
// cannot broadcast (S*S, 20) against (20, C); that product is not carried over.
// Here the function is what it is: 40 weights per pixel, then a two-term
// multiply-add per output element.
//
// What bounds it on an H100: the output. At (256, 32, 32, 20*64) bf16 it is
// 671 MB (0.200 ms at 3.35 TB/s); the inputs are 21 joints a sample and the
// arithmetic is about 25 flops per (pixel, bone) plus 3 per element, far under
// the fp32 rate. What the design does about it: a block takes one sample and
// a strip of 32 pixels, keeps the bones' endpoint features (2 x 20 x C, gathered
// bone-major, so that the 16 bytes a thread needs are one conflict-free load)
// and the strip's 2 x 32 x 20 weights in shared memory, and writes the strip
// as 16-byte stores, neighbouring threads on neighbouring addresses; nothing
// but the output touches device memory twice.
//
// The mask is a step, so the geometry is written to round as the plain
// PyTorch version's elementwise ops do: this file is compiled with -fmad=false
// (no contraction of a*b+c into one rounding) and uses hypotf where the plain
// version uses torch.hypot. A pixel within rounding of the threshold can still
// fall on the other side; the comparisons count those pixels and leave them out.
//
// C interface (bound with ctypes): bone_splat_bf16 / bone_splat_f32 launch on
// the given stream, allocate nothing, do not synchronise, and return
// cudaGetLastError() (or cudaErrorInvalidValue for shapes they do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int JOINTS = 21;
constexpr int BONES = 20;
constexpr int PIX = 32;        // pixels per block
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 47 * 1024;   // dynamic part; with `ends` under the 48 KB that need no opt-in

__constant__ int PARENT[BONES] = {0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19};
__constant__ int CHILD[BONES] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};

// Per feature type: rounding of an fp32 value to the type (kept as fp32), and
// a 16-byte load and store of VEC consecutive elements from and to fp32.
template <typename T> struct Feat;

template <> struct Feat<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void load(const float* src, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* dst, const float* v) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Feat<bf16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void load(const bf16* src, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* t = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(t[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* dst, const float* v) {
    uint4 u;
    unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<unsigned*>(&t);
    }
    *reinterpret_cast<uint4*>(dst) = u;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
bone_splat_kernel(const float* __restrict__ uv, const T* __restrict__ feat,
                  T* __restrict__ out, int S, int C, float distance) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* fa = reinterpret_cast<T*>(smem_raw);           // (BONES, C) start-joint features
  T* fb = fa + BONES * C;                           // (BONES, C) end-joint features
  float* wa = reinterpret_cast<float*>(fb + BONES * C);   // (PIX, BONES) masked weights
  float* wb = wa + PIX * BONES;
  __shared__ float ends[4][BONES];                  // ax, ay, bx, by in pixels

  const size_t n = blockIdx.y;
  const int p0 = blockIdx.x * PIX;
  const int npix = S * S;

  const T* fn = feat + n * JOINTS * C;
  for (int i = threadIdx.x; i < BONES * C; i += THREADS) {
    const int k = i / C;
    const int c = i - k * C;
    fa[i] = fn[PARENT[k] * C + c];
    fb[i] = fn[CHILD[k] * C + c];
  }
  if (threadIdx.x < BONES) {
    const float* u = uv + n * JOINTS * 2;
    const int a = PARENT[threadIdx.x];
    const int b = CHILD[threadIdx.x];
    const float size = (float)S;
    ends[0][threadIdx.x] = (u[2 * a] + 1.0f) / 2.0f * size;
    ends[1][threadIdx.x] = (u[2 * a + 1] + 1.0f) / 2.0f * size;
    ends[2][threadIdx.x] = (u[2 * b] + 1.0f) / 2.0f * size;
    ends[3][threadIdx.x] = (u[2 * b + 1] + 1.0f) / 2.0f * size;
  }
  __syncthreads();

  // the strip's weights: one (pixel, bone) pair per thread and step
  for (int i = threadIdx.x; i < PIX * BONES; i += THREADS) {
    const int pl = i / BONES;
    const int k = i - pl * BONES;
    const int p = p0 + pl;
    float w_a = 0.0f, w_b = 0.0f;
    if (p < npix) {
      const float px = (float)(p % S) + 0.5f;
      const float py = (float)(p / S) + 0.5f;
      const float ax = ends[0][k], ay = ends[1][k], bx = ends[2][k], by = ends[3][k];
      const float dx = bx - ax, dy = by - ay;
      const float seg_len = hypotf(dx, dy);
      const float len = seg_len > 0.0f ? seg_len : 1.0f;   // a == b: weight 0, not NaN
      const float ux = dx / len, uy = dy / len;
      const float s = (ax - px) * ux + (ay - py) * uy;
      const float t = (px - bx) * ux + (py - by) * uy;
      const float h = fmaxf(fmaxf(s, t), 0.0f);
      const float cross = (px - ax) * uy - (py - ay) * ux;
      const float seg_dist = hypotf(h, cross);
      if (seg_dist < distance && seg_len > 0.0f) {
        const float da = sqrtf((px - ax) * (px - ax) + (py - ay) * (py - ay));
        const float db = sqrtf((px - bx) * (px - bx) + (py - by) * (py - by));
        float denom = da + db;
        denom = denom > 0.0f ? denom : 1.0f;
        w_a = 1.0f - da / denom;
        w_b = 1.0f - db / denom;
      }
    }
    wa[i] = Feat<T>::round(w_a);
    wb[i] = Feat<T>::round(w_b);
  }
  __syncthreads();

  // the strip's output: one 16-byte vector (VEC channels of one bone of one
  // pixel) per thread and step; a pixel's row is BONES * C elements, vector v
  // of it lies at element v * VEC, in the row and in fa and fb alike
  constexpr int VEC = Feat<T>::VEC;
  const int cv = C / VEC;
  const int row_vecs = BONES * cv;
  T* outn = out + n * npix * BONES * C;
  for (int i = threadIdx.x; i < PIX * row_vecs; i += THREADS) {
    const int pl = i / row_vecs;
    const int v = i - pl * row_vecs;
    const int p = p0 + pl;
    if (p >= npix) break;
    const int k = v / cv;
    const float w_a = wa[pl * BONES + k];
    const float w_b = wb[pl * BONES + k];
    float a[VEC], b[VEC], r[VEC];
    Feat<T>::load(fa + v * VEC, a);
    Feat<T>::load(fb + v * VEC, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) r[j] = w_a * a[j] + w_b * b[j];
    Feat<T>::store(outn + ((size_t)p * row_vecs + v) * VEC, r);
  }
}

template <typename T>
int smem_bytes(int C) { return 2 * BONES * C * (int)sizeof(T) + 2 * PIX * BONES * 4; }

template <typename T>
int launch(const void* uv, const void* feat, void* out, int B, int S, int C,
           float distance, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C <= 0 || C % Feat<T>::VEC ||
      smem_bytes<T>(C) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S * S + PIX - 1) / PIX, B);
  bone_splat_kernel<T><<<grid, THREADS, smem_bytes<T>(C), (cudaStream_t)stream>>>(
      (const float*)uv, (const T*)feat, (T*)out, S, C, distance);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bone_splat_bf16(const void* uv, const void* feat, void* out, int B,
                               int S, int C, float distance, void* stream) {
  return launch<bf16>(uv, feat, out, B, S, C, distance, stream);
}

extern "C" int bone_splat_f32(const void* uv, const void* feat, void* out, int B,
                              int S, int C, float distance, void* stream) {
  return launch<float>(uv, feat, out, B, S, C, distance, stream);
}

// Largest channel count a launch takes for features of `elem_bytes` bytes
// (the bones' endpoint features must fit shared memory).
extern "C" int bone_splat_max_channels(int elem_bytes) {
  return (MAX_SMEM - 2 * PIX * BONES * 4) / (2 * BONES * elem_bytes);
}

extern "C" const char* bone_splat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
