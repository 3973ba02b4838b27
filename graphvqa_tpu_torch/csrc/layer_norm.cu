// LayerNorm of the Transformer stacks (nn/transformer.py:LayerNorm), forward
// and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves flax's nn.LayerNorm to XLA,
// which fuses it. Unfused in PyTorch it is 14 kernels a forward and about 30
// a backward, each over a float32 copy of the rows; the stacks call it 27
// times a train step and 357 times an eval batch (the greedy decoders).
//
// Per row of x [rows, D] (f32 or bf16), with float32 statistics as flax
// takes them (E[x^2] - E[x]^2):
//   mean = sum(x) / D,  m2 = sum(x*x) / D,  v = m2 - mean*mean
//   rstd = rsqrt(max(v, 0) + eps)
//   y    = (x - mean) * (rstd * weight) + bias        rounded to y's dtype
// in that order, each product and sum rounded as the plain tensor code
// rounds it (the _rn intrinsics keep nvcc from contracting them into FMAs);
// only the order of the row sums differs. The backward, with g = dy * weight
// and xhat = (x - mean) * rstd:
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat))   rounded to x's dtype
//   dx = rstd * (g - mean(g))           where v < 0 (the clamp passes nothing)
//   dweight = sum over rows of dy * xhat,  dbias = sum over rows of dy
//
// Bound on the H100 (3.35 TB/s): bytes. The forward reads x and writes y
// once, plus 8 bytes a row of statistics when autograd keeps them (16,000 x
// 512 bf16: 32.9 MB, 9.8 us); the backward reads x and dy and writes dx
// once, plus the statistics and the per-block partials (49.2 MB + ~2 MB).
// ~8 flops an element is far below the card's rate.
//
// Design.
//  * One warp a row, several rows a block, the row held in registers: each
//    lane loads V consecutive elements at a time (16 bytes of the narrowest
//    dtype; V = 1 where the width or an address does not allow it), chunk k
//    of lane l at column (32k + l) * V, so a warp's loads are contiguous.
//    A lane holds up to E elements (16 or 32), so D <= 32 * E <= 1024.
//  * The sums are each lane's in order, then a butterfly over the warp:
//    every lane ends with the same totals, and a row's result does not
//    depend on the launch.
//  * weight and bias go to shared memory once a block; blocks stride over
//    the rows, so a grid of a few blocks an SM reads them once each.
//  * Backward: each lane keeps its columns' partial sums of dy * xhat and dy
//    in registers over the block's rows; the block adds its warps' in warp
//    order into one partial row per block, and a second launch adds the
//    blocks' partials in block order. No atomics on the gradients, so two
//    runs give the same bits.
//  * The statistics of a row are (mean, rstd), rstd negated where the clamp
//    was active (rstd is positive, so its sign is free to carry that bit).
//  * Capture-safe: the kernels launch on the caller's stream, set no
//    attribute, allocate nothing (the wrapper allocates y, the statistics
//    and the partials) and use static shared memory only; the grids read
//    the device's SM count once, on the first launch. Block 0 of each
//    forward and backward launch adds one to a 64-bit word on the card, so
//    a CUDA graph's replay counts its launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;                   // rows in flight per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 1024;                 // 32 lanes x 32 elements

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Vec<T, V> r = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(r.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Vec<T, V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Vec<T, V>*>(p) = r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename Tx, typename Ty, int V, int E>
__global__ void __launch_bounds__(kThreads)
layer_norm_forward_kernel(const Tx* __restrict__ x,
                          const float* __restrict__ weight,
                          const float* __restrict__ bias, Ty* __restrict__ y,
                          float* __restrict__ stats, int rows, int D,
                          float eps, unsigned long long* launches) {
  constexpr int NC = E / V;
  __shared__ float sw[kMaxD], sb[kMaxD];
  for (int c = threadIdx.x; c < D; c += kThreads) {
    sw[c] = weight[c];
    sb[c] = bias[c];
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  const int lane = threadIdx.x & 31;
  const float inv_d = 1.0f / static_cast<float>(D);
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kWarps) {
    const Tx* xr = x + static_cast<size_t>(row) * D;
    float v[NC][V];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (k * 32 + lane) * V;
      if (c < D) {
        load<Tx, V>(xr + c, v[k]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[k][i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s = __fadd_rn(s, v[k][i]);
        s2 = __fadd_rn(s2, __fmul_rn(v[k][i], v[k][i]));
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = __fmul_rn(s, inv_d);
    const float var = __fsub_rn(__fmul_rn(s2, inv_d), __fmul_rn(mean, mean));
    const float rstd = rsqrtf(__fadd_rn(fmaxf(var, 0.f), eps));
    Ty* yr = y + static_cast<size_t>(row) * D;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (k * 32 + lane) * V;
      if (c < D) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float a = __fmul_rn(rstd, sw[c + i]);
          o[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[k][i], mean), a), sb[c + i]);
        }
        store<Ty, V>(yr + c, o);
      }
    }
    if (stats != nullptr && lane == 0) {
      stats[2 * static_cast<size_t>(row)] = mean;
      stats[2 * static_cast<size_t>(row) + 1] = var < 0.f ? -rstd : rstd;
    }
  }
}

// partial [gridDim.x, 2, D]: per block, the sums of dy * xhat, then of dy,
// over the block's rows
template <typename Tx, typename Ty, int V, int E>
__global__ void __launch_bounds__(kThreads)
layer_norm_backward_kernel(const Ty* __restrict__ dy,
                           const Tx* __restrict__ x,
                           const float* __restrict__ weight,
                           const float* __restrict__ stats,
                           Tx* __restrict__ dx, float* __restrict__ partial,
                           int rows, int D, unsigned long long* launches) {
  constexpr int NC = E / V;
  __shared__ float sw[kMaxD];
  __shared__ float red[kWarps][kMaxD];
  for (int c = threadIdx.x; c < D; c += kThreads) sw[c] = weight[c];
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_d = 1.0f / static_cast<float>(D);
  float acc_w[NC][V], acc_b[NC][V];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc_w[k][i] = acc_b[k][i] = 0.f;
  }
  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * D;
    const float mean = stats[2 * static_cast<size_t>(row)];
    const float r_signed = stats[2 * static_cast<size_t>(row) + 1];
    const float rstd = fabsf(r_signed);
    float xh[NC][V], g[NC][V];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (k * 32 + lane) * V;
      if (c < D) {
        float xv[V], dv[V];
        load<Tx, V>(x + base + c, xv);
        load<Ty, V>(dy + base + c, dv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          xh[k][i] = __fmul_rn(__fsub_rn(xv[i], mean), rstd);
          g[k][i] = __fmul_rn(dv[i], sw[c + i]);
          sg = __fadd_rn(sg, g[k][i]);
          sgx = __fadd_rn(sgx, __fmul_rn(g[k][i], xh[k][i]));
          acc_w[k][i] = __fadd_rn(acc_w[k][i], __fmul_rn(dv[i], xh[k][i]));
          acc_b[k][i] = __fadd_rn(acc_b[k][i], dv[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) xh[k][i] = g[k][i] = 0.f;
      }
    }
    const float mg = __fmul_rn(warp_sum(sg), inv_d);
    const float mgx =
        r_signed < 0.f ? 0.f : __fmul_rn(warp_sum(sgx), inv_d);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (k * 32 + lane) * V;
      if (c < D) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          o[i] = __fmul_rn(
              rstd, __fsub_rn(__fsub_rn(g[k][i], mg), __fmul_rn(xh[k][i], mgx)));
        }
        store<Tx, V>(dx + base + c, o);
      }
    }
  }
  // the block's partials: its warps' column sums added in warp order
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * D;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (k * 32 + lane) * V;
      if (c < D) {
#pragma unroll
        for (int i = 0; i < V; ++i)
          red[warp][c + i] = pass == 0 ? acc_w[k][i] : acc_b[k][i];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float s = red[0][c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, red[w][c]);
      out[pass * D + c] = s;
    }
    __syncthreads();
  }
}

// dweight, dbias [D] f32 from partial [blocks, 2, D]: 32 columns a block,
// warp w adding blocks w, w + kWarps, ... in order, then the warps' sums in
// warp order
__global__ void __launch_bounds__(kThreads)
layer_norm_reduce_kernel(const float* __restrict__ partial, int blocks, int D,
                         float* __restrict__ dweight,
                         float* __restrict__ dbias) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;   // over 2 * D
  float s = 0.f;
  if (col < 2 * D) {
    for (int b = warp; b < blocks; b += kWarps)
      s = __fadd_rn(s, partial[static_cast<size_t>(b) * 2 * D + col]);
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < 2 * D) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, red[w][lane]);
    if (col < D) {
      dweight[col] = t;
    } else {
      dbias[col - D] = t;
    }
  }
}

// the wide vector of a dtype pair: 16 bytes of its narrower dtype
template <typename Tx, typename Ty>
constexpr int wide() {
  return (std::is_same<Tx, float>::value && std::is_same<Ty, float>::value)
             ? 4 : 8;
}

__host__ bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the grid over `rows`: a block per kWarps rows, stopped at `per_sm` blocks
// an SM of the current device (its SM count read once); 0 on an error
__host__ int grid_blocks(int rows, int per_sm) {
  constexpr int kMaxDevices = 64;
  static int sm_counts[kMaxDevices] = {};
  int dev = 0;
  if (rows < 1 || cudaGetDevice(&dev) != cudaSuccess || dev < 0 ||
      dev >= kMaxDevices)
    return 0;
  if (sm_counts[dev] == 0 &&
      cudaDeviceGetAttribute(&sm_counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  const int want = (rows + kWarps - 1) / kWarps;
  return want < sm_counts[dev] * per_sm ? want : sm_counts[dev] * per_sm;
}

// blocks an SM the grids stop at: the forward's blocks are light; the
// backward's registers and shared memory hold about two a SM
constexpr int kForwardBlocksPerSm = 8;
constexpr int kBackwardBlocksPerSm = 2;

// Each launch picks its variant from what it is given: E = 16 elements a
// lane for D <= 512, else 32; V = 16 bytes of the pair's narrower dtype
// where D and every row pointer allow it, else 1.
template <typename Tx, typename Ty>
int forward_launch(const void* x, const void* weight, const void* bias,
                   void* y, void* stats, int rows, int D, float eps,
                   void* launches, cudaStream_t stream) {
  constexpr int W = wide<Tx, Ty>();
  using Kernel = void (*)(const Tx*, const float*, const float*, Ty*, float*,
                          int, int, float, unsigned long long*);
  const bool vec = D % W == 0 && aligned(x, W * sizeof(Tx)) &&
                   aligned(y, W * sizeof(Ty));
  const Kernel kernel =
      D <= 512 ? (vec ? layer_norm_forward_kernel<Tx, Ty, W, 16>
                      : layer_norm_forward_kernel<Tx, Ty, 1, 16>)
               : (vec ? layer_norm_forward_kernel<Tx, Ty, W, 32>
                      : layer_norm_forward_kernel<Tx, Ty, 1, 32>);
  const int blocks = grid_blocks(rows, kForwardBlocksPerSm);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const Tx*>(x), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<Ty*>(y),
      static_cast<float*>(stats), rows, D, eps,
      static_cast<unsigned long long*>(launches));
  return static_cast<int>(cudaGetLastError());
}

template <typename Tx, typename Ty>
int backward_launch(const void* dy, const void* x, const void* weight,
                    const void* stats, void* dx, void* partial,
                    void* dweight, void* dbias, int rows, int D, int blocks,
                    void* launches, cudaStream_t stream) {
  constexpr int W = wide<Tx, Ty>();
  using Kernel = void (*)(const Ty*, const Tx*, const float*, const float*,
                          Tx*, float*, int, int, unsigned long long*);
  const bool vec = D % W == 0 && aligned(dy, W * sizeof(Ty)) &&
                   aligned(x, W * sizeof(Tx)) && aligned(dx, W * sizeof(Tx));
  const Kernel kernel =
      D <= 512 ? (vec ? layer_norm_backward_kernel<Tx, Ty, W, 16>
                      : layer_norm_backward_kernel<Tx, Ty, 1, 16>)
               : (vec ? layer_norm_backward_kernel<Tx, Ty, W, 32>
                      : layer_norm_backward_kernel<Tx, Ty, 1, 32>);
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const Ty*>(dy), static_cast<const Tx*>(x),
      static_cast<const float*>(weight), static_cast<const float*>(stats),
      static_cast<Tx*>(dx), static_cast<float*>(partial), rows, D,
      static_cast<unsigned long long*>(launches));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_reduce_kernel<<<(2 * D + 31) / 32, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), blocks, D,
      static_cast<float*>(dweight), static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}

using ForwardFn = int (*)(const void*, const void*, const void*, void*,
                          void*, int, int, float, void*, cudaStream_t);
using BackwardFn = int (*)(const void*, const void*, const void*, const void*,
                           void*, void*, void*, void*, int, int, int, void*,
                           cudaStream_t);

// dtype codes: 0 float32, 1 bfloat16
ForwardFn forward_for(int x_dtype, int y_dtype) {
  using B = __nv_bfloat16;
  if (x_dtype == 0 && y_dtype == 0) return forward_launch<float, float>;
  if (x_dtype == 0 && y_dtype == 1) return forward_launch<float, B>;
  if (x_dtype == 1 && y_dtype == 0) return forward_launch<B, float>;
  if (x_dtype == 1 && y_dtype == 1) return forward_launch<B, B>;
  return nullptr;
}

BackwardFn backward_for(int x_dtype, int y_dtype) {
  using B = __nv_bfloat16;
  if (x_dtype == 0 && y_dtype == 0) return backward_launch<float, float>;
  if (x_dtype == 0 && y_dtype == 1) return backward_launch<float, B>;
  if (x_dtype == 1 && y_dtype == 0) return backward_launch<B, float>;
  if (x_dtype == 1 && y_dtype == 1) return backward_launch<B, B>;
  return nullptr;
}

}  // namespace

// y [rows, D] in y_dtype from x [rows, D] in x_dtype (D in [1, 1024],
// contiguous rows); stats [rows, 2] f32 (mean, signed rstd) or null.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// widths or dtypes it has no kernel for.
extern "C" int layer_norm_forward_launch(int x_dtype, int y_dtype,
                                         const void* x, const void* weight,
                                         const void* bias, void* y,
                                         void* stats, int rows, int D,
                                         float eps, void* launches,
                                         void* stream) {
  ForwardFn fn = forward_for(x_dtype, y_dtype);
  if (fn == nullptr || rows < 1 || D < 1 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  return fn(x, weight, bias, y, stats, rows, D, eps, launches,
            static_cast<cudaStream_t>(stream));
}

// The blocks of the backward's grid over `rows` on the current device: the
// rows of the partials [blocks, 2, D] f32 that the caller allocates for
// layer_norm_backward_launch. 0 on an error.
extern "C" int layer_norm_backward_blocks(int rows) {
  return grid_blocks(rows, kBackwardBlocksPerSm);
}

// dx [rows, D] in x_dtype, dweight and dbias [D] f32 from dy [rows, D] in
// y_dtype, x, weight and the forward's stats; partial [blocks, 2, D] f32 is
// scratch, blocks as layer_norm_backward_blocks gave it. Two launches: the
// rows, then the column reduction.
extern "C" int layer_norm_backward_launch(int x_dtype, int y_dtype,
                                          const void* dy, const void* x,
                                          const void* weight,
                                          const void* stats, void* dx,
                                          void* partial, void* dweight,
                                          void* dbias, int rows, int D,
                                          int blocks, void* launches,
                                          void* stream) {
  BackwardFn fn = backward_for(x_dtype, y_dtype);
  if (fn == nullptr || rows < 1 || D < 1 || D > kMaxD || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return fn(dy, x, weight, stats, dx, partial, dweight, dbias, rows, D,
            blocks, launches, static_cast<cudaStream_t>(stream));
}
