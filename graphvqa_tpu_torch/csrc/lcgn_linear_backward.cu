// The backward of LCGN's node-wise float32 linears over the real node rows
// (lcgn_linear.cu's forward), for Hopper (sm_90a). ops/lcgn_linear.py
// documents the function, its bound and its design; lcgn_linear.cuh holds
// the GEMM core.
//
// Replaces no TPU kernel: XLA differentiates the JAX package's dots over
// every padded node row. For y = mask * (x . W^T + b) and its cotangent dy:
//   dx[r] = dy[r] . W on the real rows, 0 on the padding rows
//   dW    = sum over real rows r of dy[r]^T x[r]
//   db    = sum over real rows r of dy[r]
// One launch computes both products: its first blocks are dW's tiles, each
// summing the real rows of one of `splits` equal runs of the row list (a
// split-K: the k dimension is the row, both operands gathered by perm into
// the staged tiles), its others dx's tiles over every position as the
// forward's are (W read in place, its rows the k). The card starts blocks
// roughly in order, so dW's (each as deep as its run) start first and dx's
// (Nout deep, or padding only and short) fill in around them; at most 8
// splits, so a run of a GQA batch's ~3,700 real rows is about as deep as
// dx's 512 (8 against 16 splits: 60 against 181 us at 512 -> 512). The
// blocks of dW's first column of tiles also sum their staged dy for db. With splits > 1 each
// split writes its own partial tile, and a second launch adds the partials
// in split order. No atomics on the gradients: two runs give the same bits.
// Block 0 of each backward adds one to a 64-bit word on the card.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "lcgn_linear.cuh"

namespace lcgn {
namespace {

constexpr int kMaxSplits = 8;
constexpr int kReduceThreads = 256;

struct Params {
  const float* dy;
  const float* x;
  const float* w;
  const int* perm;
  const int* count;
  float* dx;        // null: no dx
  float* dw;
  float* db;        // null: no bias
  float* partial;   // [splits, Nout * K + Nout] where splits > 1
  unsigned long long* launches;
  int N, K, Nout, splits, dw_blocks;
};

__host__ __device__ __forceinline__ int tiles(int n, int t) {
  return (n + t - 1) / t;
}

// Four consecutive columns of one output row, in float4 when V allows.
template <int V>
__device__ __forceinline__ void store4(float* row, int n, int width,
                                       const float (&v)[4]) {
  if (V == 4) {
    if (n < width)
      *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n + q < width) row[n + q] = v[q];
  }
}

template <int V>
__device__ __forceinline__ void dw_block(const Params& p, float* smem, int b,
                                         int M) {
  const int tn_tiles = tiles(p.K, kBN);
  const int per_split = tiles(p.Nout, kBM) * tn_tiles;
  const int s = b / per_split, t = b % per_split;
  const int m0 = (t / tn_tiles) * kBM, n0 = (t % tn_tiles) * kBN;
  const int chunk = tiles(tiles(M, p.splits), kBK) * kBK;
  const int kb = min(M, s * chunk), ke = min(M, kb + chunk);
  const bool want_db = p.db != nullptr && n0 == 0;
  float colsum = 0.0f, acc[8][8];
  Gemm<V, false, false> g;
  g.run(smem, Operand{p.dy, p.perm, p.Nout}, m0, p.Nout,
        Operand{p.x, p.perm, p.K}, n0, p.K, kb, ke, acc,
        want_db ? &colsum : nullptr);
  const size_t part = (size_t)p.Nout * p.K + p.Nout;
  float* out = p.splits == 1 ? p.dw : p.partial + s * part;
  const int tm = thread_tm(), tn = thread_tn();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + micro<false>(tm, i);
    if (row >= p.Nout) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]};
      store4<V>(out + (size_t)row * p.K, n0 + tn * 4 + 64 * h, p.K, v);
    }
  }
  if (want_db && threadIdx.x < kBM && m0 + (int)threadIdx.x < p.Nout) {
    float* db = p.splits == 1 ? p.db : p.partial + s * part + (size_t)p.Nout * p.K;
    db[m0 + threadIdx.x] = colsum;
  }
}

template <int V>
__device__ __forceinline__ void dx_block(const Params& p, float* smem, int t,
                                         int M) {
  const int tn_tiles = tiles(p.K, kBN);
  const int m0 = (t / tn_tiles) * kBM, n0 = (t % tn_tiles) * kBN;
  float acc[8][8];
  if (m0 < M) {
    Gemm<V, true, false> g;
    g.run(smem, Operand{p.dy, p.perm, p.Nout}, m0, M,
          Operand{p.w, nullptr, p.K}, n0, p.K, 0, p.Nout, acc, nullptr);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int tm = thread_tm(), tn = thread_tn();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pos = m0 + micro<true>(tm, i);
    if (pos >= p.N) continue;
    const bool real = pos < M;
    float* row = p.dx + (size_t)__ldg(p.perm + pos) * p.K;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v[4] = {real ? acc[i][4 * h] : 0.0f,
                          real ? acc[i][4 * h + 1] : 0.0f,
                          real ? acc[i][4 * h + 2] : 0.0f,
                          real ? acc[i][4 * h + 3] : 0.0f};
      store4<V>(row, n0 + tn * 4 + 64 * h, p.K, v);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, 2)
lcgn_linear_backward_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (blockIdx.x == 0 && threadIdx.x == 0 && p.launches != nullptr)
    atomicAdd(p.launches, 1ull);
  const int M = __ldg(p.count);
  const int b = blockIdx.x;
  if (b < p.dw_blocks)
    dw_block<V>(p, smem, b, M);
  else
    dx_block<V>(p, smem, b - p.dw_blocks, M);
}

// partial [splits, nw + nb] -> dw [nw] and, where db is given, db [nb]: each
// element the sum of its splits in split order.
__global__ void __launch_bounds__(kReduceThreads)
lcgn_linear_reduce_kernel(const float* __restrict__ partial, int splits,
                          int nw, int nb, float* __restrict__ dw,
                          float* __restrict__ db) {
  const int n = nw + (db != nullptr ? nb : 0);
  const size_t part = (size_t)nw + nb;
  for (int i = blockIdx.x * kReduceThreads + threadIdx.x; i < n;
       i += gridDim.x * kReduceThreads) {
    float s = partial[i];
    for (int k = 1; k < splits; ++k) s += partial[k * part + i];
    if (i < nw)
      dw[i] = s;
    else
      db[i - nw] = s;
  }
}

int sm_count(int* out) {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  *out = sms[dev];
  return 0;
}

template <int V>
int launch_backward(const Params& p, cudaStream_t stream) {
  auto kernel = lcgn_linear_backward_kernel<V>;
  static size_t allowed[kMaxDevices];
  const size_t smem = Gemm<V, true, false>::kSmemBytes >
                              Gemm<V, false, false>::kSmemBytes
                          ? Gemm<V, true, false>::kSmemBytes
                          : Gemm<V, false, false>::kSmemBytes;
  int err = allow_smem(kernel, smem, stream, allowed);
  if (err != 0) return err;
  const long long blocks =
      p.dw_blocks +
      (p.dx != nullptr ? (long long)tiles(p.N, kBM) * tiles(p.K, kBN) : 0);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err != 0 || p.splits == 1) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != 0) return err;
  const int n = p.Nout * p.K + (p.db != nullptr ? p.Nout : 0);
  const int grid = std::min(tiles(n, kReduceThreads), 4 * sms);
  lcgn_linear_reduce_kernel<<<grid, kReduceThreads, 0, stream>>>(
      p.partial, p.splits, p.Nout * p.K, p.Nout, p.dw, p.db);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lcgn

// How many runs of rows dW's split-K takes for w [Nout, K] on the current
// device: enough tiles for two blocks an SM, at most 8. 0 on an error.
extern "C" int lcgn_linear_backward_splits(int K, int Nout) {
  using namespace lcgn;
  int sms = 0;
  if (K < 1 || Nout < 1 || sm_count(&sms) != 0) return 0;
  const int t = tiles(Nout, kBM) * tiles(K, kBN);
  return std::max(1, std::min(kMaxSplits, tiles(2 * sms, t)));
}

// dx [N, K] (or null), dw [Nout, K] and db [Nout] (or null), all f32, from dy
// [N, Nout], x [N, K] and w [Nout, K] f32 and lcgn_rows_launch's perm and
// count; partial [splits, Nout * K + Nout] f32 is scratch where splits > 1
// (splits as lcgn_linear_backward_splits gave it). One launch, and a second
// where splits > 1.
extern "C" int lcgn_linear_backward_launch(
    const void* dy, const void* x, const void* w, const void* perm,
    const void* count, void* dx, void* dw, void* db, void* partial,
    int splits, void* launches, int N, int K, int Nout, void* stream) {
  using namespace lcgn;
  if (N < 1 || K < 1 || Nout < 1 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && partial == nullptr) ||
      (long long)Nout * K + Nout > 2147483647LL / kMaxSplits)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(dy), static_cast<const float*>(x),
           static_cast<const float*>(w), static_cast<const int*>(perm),
           static_cast<const int*>(count), static_cast<float*>(dx),
           static_cast<float*>(dw), static_cast<float*>(db),
           static_cast<float*>(partial),
           static_cast<unsigned long long*>(launches), N, K, Nout, splits,
           splits * tiles(Nout, kBM) * tiles(K, kBN)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && Nout % 4 == 0 && aligned16(dy) &&
                   aligned16(x) && aligned16(w) && aligned16(dw) &&
                   (dx == nullptr || aligned16(dx)) &&
                   (partial == nullptr || aligned16(partial));
  return vec ? launch_backward<4>(p, s) : launch_backward<1>(p, s);
}
