// What the GINE round's forward (gine_messages.cu) and backward
// (gine_messages_backward.cu) share: the dtype helpers, the staging of one
// graph's edges, the column tiles and the shared-memory attribute. The
// design is in ops/gine_messages.py and at the top of each kernel's source.
#pragma once

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gine {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
// local indices and edge positions are kept as int16 in shared memory
constexpr int kMaxLocal = 32767;

// dtype codes: 0 float32, 1 bfloat16
using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, as a tensor op in T rounds its float32 result
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> ld(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void floats(const Vec<T, V>& r, float (&out)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(r.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void st(T* p, const float (&in)[V]) {
  Vec<T, V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Vec<T, V>*>(p) = r;
}

// Graph g's edges into shared memory: s_dl, s_sl [epg] hold a real edge's
// local indices and -1 on the others; [s_dstart[v], s_dend[v]) is
// destination v's run of in-edges (empty where it has none). Asserts that
// the real edges come first, sorted by destination. Returns the number of
// real edges; ends with a barrier. Every thread of the block calls it.
__device__ int stage_graph(const int32_t* __restrict__ dl,
                           const int32_t* __restrict__ sl,
                           const uint8_t* __restrict__ mask, int g, int npg,
                           int epg, short* s_dl, short* s_sl, int* s_dstart,
                           int* s_dend) {
  for (int v = threadIdx.x; v < npg; v += kThreads)
    s_dstart[v] = s_dend[v] = 0;
  int n_real = 0;
  for (int base = 0; base < epg; base += kThreads) {
    const int k = base + threadIdx.x;
    int real = 0;
    if (k < epg) {
      const size_t e = (size_t)g * epg + k;
      const int d = dl[e], s = sl[e];
      real = mask[e] != 0 && d >= 0 && d < npg && s >= 0 && s < npg;
      s_dl[k] = (short)(real ? d : -1);
      s_sl[k] = (short)(real ? s : -1);
    }
    n_real += __syncthreads_count(real);
  }
  for (int k = threadIdx.x; k < epg; k += kThreads) {
    const int d = s_dl[k];
    if (d < 0) continue;
    const int prev = k == 0 ? d : s_dl[k - 1];
    // each graph's real edges first and sorted by destination
    assert(prev >= 0 && prev <= d);
    if (k == 0 || prev != d) s_dstart[d] = k;
    if (k + 1 == epg || s_dl[k + 1] != d) s_dend[d] = k + 1;
  }
  __syncthreads();
  return n_real;
}

__host__ __device__ inline size_t round16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Column tiles over `cols` columns in chunks of V, one lane a chunk, at
// most 32 chunks a tile, spread evenly; more tiles where a tile's stage of
// npg rows x (chunks x V) elements of `elem` bytes (at least `least` bytes)
// and the `fixed` bytes beside it would pass `limit`. False when even one
// chunk a tile does not fit.
inline bool plan_tiles(int cols, int V, int npg, size_t elem, size_t fixed,
                       size_t least, size_t limit, int* cpt, int* tiles,
                       size_t* stage) {
  const int chunks = (cols + V - 1) / V;
  for (int t = (chunks + 31) / 32; t <= chunks; ++t) {
    const int c = (chunks + t - 1) / t;
    size_t s = round16((size_t)npg * c * V * elem);
    if (s < least) s = least;
    if (fixed + s <= limit) {
      *cpt = c;
      *tiles = (chunks + c - 1) / c;
      *stage = s;
      return true;
    }
  }
  return false;
}

// The current device and the dynamic shared memory a block may opt into
// there (read once a device).
inline int device_limit(int* dev, size_t* limit) {
  static int optin[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (optin[*dev] == 0) {
    int v = 0;
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 *dev);
    if (err != cudaSuccess) return (int)err;
    optin[*dev] = v;
  }
  *limit = (size_t)optin[*dev];
  return 0;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on `dev`. The
// attribute is set on an eager launch only (`allowed`, the kernel's own,
// keeps what each device was given): a launch under stream capture that
// would need it returns cudaErrorStreamCaptureUnsupported instead.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, int dev, cudaStream_t stream,
               size_t* allowed) {
  if (smem <= 48 * 1024 || smem <= allowed[dev]) return 0;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  cudaError_t err = cudaStreamIsCapturing(stream, &capture);
  if (err != cudaSuccess) return (int)err;
  if (capture != cudaStreamCaptureStatusNone)
    return (int)cudaErrorStreamCaptureUnsupported;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  allowed[dev] = smem;
  return 0;
}

}  // namespace gine
