// LCGN's node-wise float32 linears over the real node rows, forward, and the
// row list they share, for Hopper (sm_90a). ops/lcgn_linear.py documents the
// function, its bound and its design; lcgn_linear.cuh holds the GEMM core.
//
// Replaces no TPU kernel: the JAX package's GlorotLinear / nn.Dense are XLA
// dots over every padded node row. About 72 % of the rows of a GQA-shaped
// batch are padding, whose results every consumer masks.
//
//  * lcgn_rows_kernel: one block lists the rows of node_mask, the real ones
//    first and then the padding, each in row order (perm [N] int32), and
//    their count (count [1] int32), on the card: no host sync, so a CUDA
//    graph captures it.
//  * lcgn_linear_forward_kernel: y[perm[p]] = x[perm[p]] . W^T (+ b) for
//    p < count and 0 for p >= count, one 128 x 128 tile of (position, out
//    column) a block. x's rows are gathered by perm into the staged tiles;
//    W [Nout, K] is read in place (both k-contiguous). The grid covers
//    every position; a block whose positions are all padding only writes
//    its zeros.
// Block 0 of each launch adds one to a 64-bit word on the card, so a CUDA
// graph's replay counts its launches.
#include <cuda_runtime.h>

#include <cstdint>

#include "lcgn_linear.cuh"

namespace lcgn {
namespace {

constexpr int kRowsThreads = 1024;

__global__ void __launch_bounds__(kRowsThreads)
lcgn_rows_kernel(const uint8_t* __restrict__ mask, int N,
                 int* __restrict__ perm, int* __restrict__ count,
                 unsigned long long* launches) {
  __shared__ int warp_sums[kRowsThreads / 32];
  if (threadIdx.x == 0 && launches != nullptr) atomicAdd(launches, 1ull);
  const int per = (N + kRowsThreads - 1) / kRowsThreads;
  const int lo = min(N, (int)threadIdx.x * per), hi = min(N, lo + per);
  int c = 0;
  for (int r = lo; r < hi; ++r) c += mask[r] != 0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int v = c;  // inclusive scan of the chunks' counts over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int total = warp_sums[kRowsThreads / 32 - 1];
  int real = v - c + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int r = lo; r < hi; ++r) {
    // a padding row's place: after every real row, then the padding rows
    // before it (r - real of them)
    if (mask[r] != 0)
      perm[real++] = r;
    else
      perm[total + r - real] = r;
  }
  if (threadIdx.x == 0) *count = total;
}

// One block an SM: both operands are read k-contiguous, which at two
// blocks an SM (128 registers) spills.
constexpr int kForwardBlocksPerSm = 1;

template <int V>
__global__ void __launch_bounds__(kThreads, kForwardBlocksPerSm)
lcgn_linear_forward_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           const int* __restrict__ perm,
                           const int* __restrict__ count,
                           float* __restrict__ y,
                           unsigned long long* launches, int N, int K,
                           int Nout) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&
      launches != nullptr)
    atomicAdd(launches, 1ull);
  const int M = __ldg(count);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tm = thread_tm(), tn = thread_tn();
  float acc[8][8];
  if (m0 < M) {
    Gemm<V, true, true> g;
    g.run(smem, Operand{x, perm, K}, m0, M, Operand{w, nullptr, K}, n0, Nout,
          0, K, acc, nullptr);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  float b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + micro<true>(tn, j);
    b[j] = bias != nullptr && n < Nout ? __ldg(bias + n) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pos = m0 + micro<true>(tm, i);
    if (pos >= N) continue;
    const bool real = pos < M;
    float* yr = y + (size_t)__ldg(perm + pos) * Nout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + micro<true>(tn, j);
      if (n < Nout) yr[n] = real ? acc[i][j] + b[j] : 0.0f;
    }
  }
}

template <int V>
int launch_forward(const float* x, const float* w, const float* bias,
                   const int* perm, const int* count, float* y,
                   unsigned long long* launches, int N, int K, int Nout,
                   cudaStream_t stream) {
  auto kernel = lcgn_linear_forward_kernel<V>;
  static size_t allowed[kMaxDevices];
  const size_t smem = Gemm<V, true, true>::kSmemBytes;
  int err = allow_smem(kernel, smem, stream, allowed);
  if (err != 0) return err;
  const dim3 grid((Nout + kBN - 1) / kBN, (N + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, bias, perm, count, y,
                                           launches, N, K, Nout);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lcgn

// perm [N] int32 and count [1] int32 from mask [N] (bool bytes): the real
// rows in order, then the padding rows in order, and how many are real.
// launches: an 8-byte count on this card or null. Launches on the current
// device and `stream`; returns cudaGetLastError() after the launch.
extern "C" int lcgn_rows_launch(const void* mask, void* perm, void* count,
                                void* launches, int N, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  lcgn::lcgn_rows_kernel<<<1, lcgn::kRowsThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), N, static_cast<int*>(perm),
      static_cast<int*>(count),
      static_cast<unsigned long long*>(launches));
  return (int)cudaGetLastError();
}

// y [N, Nout] f32 from x [N, K] f32, w [Nout, K] f32, bias [Nout] f32 or
// null, and lcgn_rows_launch's perm and count: the real rows' products (plus
// the bias), 0 on the padding rows.
extern "C" int lcgn_linear_launch(const void* x, const void* w,
                                  const void* bias, const void* perm,
                                  const void* count, void* y, void* launches,
                                  int N, int K, int Nout, void* stream) {
  using namespace lcgn;
  if (N < 1 || K < 1 || Nout < 1) return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto fn) {
    return fn(xf, wf, static_cast<const float*>(bias),
              static_cast<const int*>(perm), static_cast<const int*>(count),
              static_cast<float*>(y),
              static_cast<unsigned long long*>(launches), N, K, Nout, s);
  };
  if (K % 4 == 0 && aligned16(x) && aligned16(w))
    return go(launch_forward<4>);
  return go(launch_forward<1>);
}
