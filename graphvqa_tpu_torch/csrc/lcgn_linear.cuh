// The float32 GEMM core of LCGN's node-wise linears over the real node rows
// (lcgn_linear.cu, lcgn_linear_backward.cu; ops/lcgn_linear.py documents the
// design). One 128 x 128 output tile a block of 256 threads, each thread an
// 8 x 8 micro-tile in registers; the reduction dimension in steps of 16
// through a 3-stage ring of shared memory filled with cp.async; FFMA only,
// float32 accumulation in a fixed order.
//
// C[m][n] = sum over k of A[m][k] * B[k][n]. Each operand is read as lines of
// a row-major matrix, in one of two layouts:
//  * "tile rows" (KC): a line is one of the tile's 128 rows (m for A, n for
//    B), of which a stage stages 16 consecutive k. The rows of a gathered
//    operand are perm[position], valid below a position limit.
//  * "k lines": a line is one k, of which a stage stages 128 consecutive
//    columns. A gathered operand reads row perm[k] of its matrix.
// Pieces of 4 floats (16-byte cp.async) where the widths and addresses
// allow, else of one float; a piece out of range is zero-filled, so a sum
// over it adds 0.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace lcgn {

constexpr int kBM = 128, kBN = 128, kBK = 16, kStages = 3, kThreads = 256;
constexpr int kPad = 4;             // floats after each staged line
constexpr int kMaxDevices = 64;

// One operand: a row-major matrix of row stride `ld` floats; row i is
// perm[i] where perm is given.
struct Operand {
  const float* base;
  const int* perm;
  int ld;
};

__device__ __forceinline__ int row_of(const Operand& o, int i) {
  return o.perm != nullptr ? __ldg(o.perm + i) : i;
}

template <int V>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 * V : 0;
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The thread's place in the 16 x 16 grid of micro-tiles: a warp covers 4
// rows of it by 8 columns.
__device__ __forceinline__ int thread_tm() {
  return (threadIdx.x / 64) * 4 + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int thread_tn() {
  return ((threadIdx.x / 32) % 2) * 8 + threadIdx.x % 8;
}

// The tile row (column) of the thread's i-th micro-tile row (column). In the
// tile-rows layout the 8 are strided, so a quarter-warp's 16-byte reads hit
// 8 consecutive staged lines (distinct banks: the line stride is 5 x 16
// bytes); in the k-lines layout they are two runs of 4, read as float4.
template <bool KC>
__device__ __forceinline__ int micro(int t, int i) {
  return KC ? t + 16 * i : t * 4 + (i & 3) + 64 * (i >> 2);
}

// Four consecutive k of one staged line (a tile-rows operand's), in one
// shared-memory read.
__device__ __forceinline__ void lds4(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <bool KC>
struct Layout {
  static constexpr int kStride = KC ? kBK + kPad : kBM + kPad;
  static constexpr int kFloats = (KC ? kBM : kBK) * kStride;
};

// The GEMM of one tile: acc[i][j] += sum over k in [k_begin, k_end) of
// A[micro(i)][k] * B[k][micro(j)] with the tile at (m0, n0).
//  A_KC: A's lines are positions m0.. of `a` below m_limit, k its columns
//        (k_end their count); else A's lines are the k, perm'd when `a`
//        gathers, below k_end, and m0.. its columns below m_limit.
//  B_KC, n0, n_limit the same for B.
// colsum, where given (k-lines A only), gets sum over k of A[k][tid] for
// tid < kBM, in k order.
template <int V, bool A_KC, bool B_KC>
struct Gemm {
  using LA = Layout<A_KC>;
  using LB = Layout<B_KC>;
  static constexpr int kStageFloats = LA::kFloats + LB::kFloats;
  static constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;
  // pieces of one operand's stage, per thread
  static constexpr int kPieces = kBM * kBK / V / kThreads;

  const float* pa[kPieces];  // tile-rows operands: each piece's line, or null
  const float* pb[kPieces];

  __device__ __forceinline__ static int kc_line(int p) {
    return (threadIdx.x + p * kThreads) / (kBK / V);
  }
  __device__ __forceinline__ static int kc_col(int p) {
    return ((threadIdx.x + p * kThreads) % (kBK / V)) * V;
  }
  __device__ __forceinline__ static int kl_line(int p) {
    return (threadIdx.x + p * kThreads) / (kBM / V);
  }
  __device__ __forceinline__ static int kl_col(int p) {
    return ((threadIdx.x + p * kThreads) % (kBM / V)) * V;
  }

  template <bool KC>
  __device__ __forceinline__ void rows(const Operand& o, int x0, int limit,
                                       const float* (&ptr)[kPieces]) {
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int pos = x0 + kc_line(p);
      ptr[p] = KC && pos < limit ? o.base + (size_t)row_of(o, pos) * o.ld
                                 : nullptr;
    }
  }

  template <bool KC>
  __device__ __forceinline__ static void load(float* s, const Operand& o,
                                              const float* const (&ptr)[kPieces],
                                              int x0, int limit, int k0,
                                              int k_end) {
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      if constexpr (KC) {
        const int f = kc_col(p);
        const bool ok = ptr[p] != nullptr && k0 + f < k_end;
        cp_async<V>(s + kc_line(p) * Layout<KC>::kStride + f,
                    ok ? ptr[p] + k0 + f : o.base, ok);
      } else {
        const int line = kl_line(p), f = kl_col(p);
        const int k = k0 + line;
        const bool ok = k < k_end && x0 + f < limit;
        cp_async<V>(s + line * Layout<KC>::kStride + f,
                    ok ? o.base + (size_t)row_of(o, k) * o.ld + x0 + f
                       : o.base,
                    ok);
      }
    }
  }

  __device__ __forceinline__ static void compute(const float* As,
                                                 const float* Bs, int tm,
                                                 int tn, float (&acc)[8][8]) {
#pragma unroll
    for (int kc = 0; kc < kBK; kc += 4) {
      float a[8][4];
      if constexpr (A_KC) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          lds4(As + micro<true>(tm, i) * LA::kStride + kc, a[i]);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                As + (kc + kk) * LA::kStride + tm * 4 + 64 * h);
            a[4 * h][kk] = v.x; a[4 * h + 1][kk] = v.y;
            a[4 * h + 2][kk] = v.z; a[4 * h + 3][kk] = v.w;
          }
        }
      }
      if constexpr (B_KC) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float b[4];
          lds4(Bs + micro<true>(tn, j) * LB::kStride + kc, b);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              acc[i][j] = fmaf(a[i][kk], b[kk], acc[i][j]);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float b[8];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                Bs + (kc + kk) * LB::kStride + tn * 4 + 64 * h);
            b[4 * h] = v.x; b[4 * h + 1] = v.y;
            b[4 * h + 2] = v.z; b[4 * h + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
        }
      }
    }
  }

  __device__ __forceinline__ void run(float* smem, const Operand& a,
                                      int m0, int m_limit, const Operand& b,
                                      int n0, int n_limit, int k_begin,
                                      int k_end, float (&acc)[8][8],
                                      float* colsum) {
    const int tm = thread_tm(), tn = thread_tn();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    rows<A_KC>(a, m0, m_limit, pa);
    rows<B_KC>(b, n0, n_limit, pb);
    const int nk = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
    auto stage = [&](int t) {
      float* s = smem + (t % kStages) * kStageFloats;
      const int k0 = k_begin + t * kBK;
      load<A_KC>(s, a, pa, m0, m_limit, k0, k_end);
      load<B_KC>(s + LA::kFloats, b, pb, n0, n_limit, k0, k_end);
    };
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < nk) stage(t);
      cp_commit();
    }
    for (int t = 0; t < nk; ++t) {
      cp_wait<kStages - 2>();
      __syncthreads();
      // the slot of tile t - 1, which every thread has finished reading
      if (t + kStages - 1 < nk) stage(t + kStages - 1);
      cp_commit();
      const float* As = smem + (t % kStages) * kStageFloats;
      if (!A_KC && colsum != nullptr && threadIdx.x < kBM) {
        float c = *colsum;
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) c += As[kk * LA::kStride + threadIdx.x];
        *colsum = c;
      }
      compute(As, As + LA::kFloats, tm, tn, acc);
    }
    cp_wait<0>();
  }
};

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device. The attribute is set on an eager launch only (`allowed` keeps what
// each device was given): a launch under stream capture that would need it
// returns cudaErrorStreamCaptureUnsupported instead.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, cudaStream_t stream,
               size_t* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem <= 48 * 1024 || smem <= allowed[dev]) return 0;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  err = cudaStreamIsCapturing(stream, &capture);
  if (err != cudaSuccess) return (int)err;
  if (capture != cudaStreamCaptureStatusNone)
    return (int)cudaErrorStreamCaptureUnsupported;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  allowed[dev] = smem;
  return 0;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace lcgn
