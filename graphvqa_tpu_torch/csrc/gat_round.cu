// Fused GAT round on the dense per-graph layout, for Hopper (sm_90a).
//
// Replaces: graphvqa_tpu/ops/pallas/fused_dense_gat.py:_round_kernel
// (pallas_fused_dense_gat), widened to the forward contract that the model
// actually calls, graphvqa_tpu/ops/dense.py:dense_gat_aggregate: bf16 or f32
// values, the per-graph instruction share `ins_value` through the attention
// row sums, the head mean, and both softmax shifts ('graph' and 'dst').
//
// Per graph b, head h, edge e (src j -> dst i, real when mask > 0):
//   logit  = leaky_relu(al[j,h] + ar[i,h] + ae[e,h])
//   p      = exp(min(logit - shift, 0))      shift: graph max or dst max
//   a      = p * (1/H) / (sum_{e->i} p + 1e-16)
//   out[i] = sum_h sum_{e->i} a[e,h] * xw[j,h,:] + sum_h rowsum_a[i,h] * ins[b,h,:]
//
// Bound on the H100 (80 GB HBM3, 3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores). At the main path's shapes, B=512 graphs, npg=64, epg=256, H=4,
// C=300, bf16 values, each input read once and the output written once:
//   xw   512*64*4*300*2 B = 78.6 MB
//   out  512*64*300*2 B   = 19.7 MB
//   ins  512*4*300*2 B    =  1.2 MB  (2.5 MB if it arrived in f32)
//   al, ar 2*512*64*4*4 B = 1.0 MB; ae 512*256*4*4 B = 2.1 MB;
//   dl, sl, mask 3*512*256*4 B = 1.6 MB
// about 104 MB, i.e. ~31 us at 3.35 TB/s. The arithmetic is ~2*H*C flops per
// real edge (~54k edges: 0.13 GFLOP, ~2 us at 67 TFLOP/s), so the round is
// bound by bytes. chip_smoke.py recomputes the bound from the tensors it runs.
//
// Design. One thread block per graph; everything per graph but xw, ins and
// out lives in shared memory (<= 27.1 KB at the top ladder rung npg=128,
// epg=1024, H=4), so the one-hot incidence and the [H, npg, npg] attention
// matrix of the TPU kernel never exist: the only bulk traffic is xw in and
// out back, which is the bound above.
// Precondition: within each graph the real edges come first, sorted by
// destination, and the padded ones follow. The dense packing
// (core/packing.py:pack_graphs_dense) lays edges out so; a device assert
// stops the kernel on anything else.
//   1. stage src/dst indices and the logits [epg, H];
//   2. one pass over the edges marks where each destination's run of
//      in-edges begins and ends (edge order is kept within a destination, so
//      every sum below runs in a fixed order and the results are
//      deterministic; no float atomics);
//   3. one thread per (destination, head) computes the shift, the exps, the
//      denominator, the normalized weights and their row sum;
//   4. threads map to (destination, channel pair): each walks its
//      destination's in-edges and accumulates a * xw[src, h, c:c+2] in f32,
//      neighbouring threads on neighbouring channels, so the xw row reads
//      coalesce. C=300 is not a multiple of 8, and a head slice starts at
//      h*600 bytes in bf16, so loads are 2-element (4 or 8 byte) vectors when
//      C is even and the pointers allow, scalar otherwise.
// A destination with no real in-edges gets 0 (its weights are never formed,
// so 0 * (1/1e-16) is never computed). Edges whose local index falls outside
// [0, npg) are treated as padding, as the JAX one-hot incidence drops them.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-16f;
constexpr int kThreads = 256;

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

template <typename T, int VEC>
__device__ __forceinline__ void fma_row(const T* p, float a, float* acc) {
  if constexpr (VEC == 2) {
    const float2 v = load2(p);
    acc[0] += a * v.x;
    acc[1] += a * v.y;
  } else {
    acc[0] += a * load1(p);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) gat_round_kernel(
    const int32_t* __restrict__ dl, const int32_t* __restrict__ sl,
    const float* __restrict__ mask, const float* __restrict__ al,
    const float* __restrict__ ar, const float* __restrict__ ae,
    const T* __restrict__ xw, const T* __restrict__ ins, T* __restrict__ out,
    int npg, int epg, int H, int C, float slope, int shift_graph) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w = reinterpret_cast<float*>(smem);   // [epg, H] logits, then weights
  float* rowsum = w + epg * H;                 // [npg, H]
  float* gmax = rowsum + npg * H;              // [H]
  int* src = reinterpret_cast<int*>(gmax + H); // [epg]
  int* dst = src + epg;                        // [epg], -1 for padding
  int* beg = dst + epg;                        // [npg] first in-edge
  int* end = beg + npg;                        // [npg] one past the last

  const int tid = threadIdx.x;
  const int64_t node0 = (int64_t)blockIdx.x * npg;
  const int64_t edge0 = (int64_t)blockIdx.x * epg;

  // 1. indices and logits; every destination starts with an empty run
  for (int i = tid; i < npg; i += blockDim.x) beg[i] = end[i] = 0;
  for (int e = tid; e < epg; e += blockDim.x) {
    const int s = sl[edge0 + e];
    const int d = dl[edge0 + e];
    const bool real = mask[edge0 + e] > 0.f && s >= 0 && s < npg && d >= 0 &&
                      d < npg;
    src[e] = real ? s : 0;
    dst[e] = real ? d : -1;
    for (int h = 0; h < H; ++h) {
      float x = kNegInf;
      if (real) {
        x = (al[(node0 + s) * H + h] + ar[(node0 + d) * H + h]) +
            ae[(edge0 + e) * H + h];
        x = x >= 0.f ? x : slope * x;
      }
      w[e * H + h] = x;
    }
  }
  __syncthreads();

  // 2. run boundaries per destination; per-graph max per head
  for (int e = tid; e < epg; e += blockDim.x) {
    const int d = dst[e];
    if (d < 0) continue;
    const int prev = e > 0 ? dst[e - 1] : -1;
    // real edges first and dst-sorted (see the precondition above)
    assert(e == 0 || (prev >= 0 && prev <= d));
    if (prev != d) beg[d] = e;
    if (e + 1 == epg || dst[e + 1] != d) end[d] = e + 1;
  }
  if (shift_graph) {
    for (int h = tid; h < H; h += blockDim.x) {
      float m = kNegInf;
      for (int e = 0; e < epg; ++e) m = fmaxf(m, w[e * H + h]);
      gmax[h] = m;
    }
  }
  __syncthreads();

  // 3. destination softmax, one thread per (destination, head)
  const float inv_h = 1.f / (float)H;
  for (int p = tid; p < npg * H; p += blockDim.x) {
    const int i = p / H, h = p - (p / H) * H;
    const int e0 = beg[i], e1 = end[i];
    float m = kNegInf;
    if (shift_graph) {
      m = gmax[h];
    } else {
      for (int e = e0; e < e1; ++e) m = fmaxf(m, w[e * H + h]);
    }
    float den = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int idx = e * H + h;
      const float ex = expf(fminf(w[idx] - m, 0.f));
      w[idx] = ex;
      den += ex;
    }
    const float r = inv_h / (den + kEps);
    float rs = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int idx = e * H + h;
      const float a = w[idx] * r;
      w[idx] = a;
      rs += a;
    }
    rowsum[p] = rs;
  }
  __syncthreads();

  // 4. aggregate, one thread per (destination, channel vector)
  const int CV = C / VEC;
  const int64_t bh = (int64_t)blockIdx.x * H;
  for (int q = tid; q < npg * CV; q += blockDim.x) {
    const int i = q / CV;
    const int c = (q - i * CV) * VEC;
    const int e0 = beg[i], e1 = end[i];
    float acc[VEC];
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    for (int e = e0; e < e1; ++e) {
      const T* row = xw + (node0 + src[e]) * H * C + c;
      for (int h = 0; h < H; ++h)
        fma_row<T, VEC>(row + (int64_t)h * C, w[e * H + h], acc);
    }
    if (ins != nullptr) {
      for (int h = 0; h < H; ++h)
        fma_row<T, VEC>(ins + (bh + h) * C + c, rowsum[i * H + h], acc);
    }
    T* o = out + (node0 + i) * C + c;
    if constexpr (VEC == 2) {
      store2(o, make_float2(acc[0], acc[1]));
    } else {
      store1(o, acc[0]);
    }
  }
}

template <typename T, int VEC>
int launch(const void* dl, const void* sl, const void* mask, const void* al,
           const void* ar, const void* ae, const void* xw, const void* ins,
           void* out, int B, int npg, int epg, int H, int C, float slope,
           int shift_graph, size_t smem, cudaStream_t stream) {
  auto kernel = gat_round_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(dl), static_cast<const int32_t*>(sl),
      static_cast<const float*>(mask), static_cast<const float*>(al),
      static_cast<const float*>(ar), static_cast<const float*>(ae),
      static_cast<const T*>(xw), static_cast<const T*>(ins),
      static_cast<T*>(out), npg, epg, H, C, slope, shift_graph);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for one graph, in bytes.
extern "C" size_t gat_round_smem_bytes(int npg, int epg, int H) {
  return sizeof(float) * ((size_t)epg * H + (size_t)npg * H + H) +
         sizeof(int) * (2 * (size_t)epg + 2 * (size_t)npg);
}

// dtype: 0 = float32, 1 = bfloat16 (xw, ins and out). dl/sl int32 [B, epg]
// (per graph: real edges first, dst-sorted, padding last),
// mask f32 [B, epg], al/ar f32 [B*npg, H], ae f32 [B, epg, H], xw [B*npg, H, C],
// ins [B, H, C] or null, out [B*npg, C]. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int gat_round_launch(int dtype, const void* dl, const void* sl,
                                const void* mask, const void* al,
                                const void* ar, const void* ae, const void* xw,
                                const void* ins, void* out, int B, int npg,
                                int epg, int H, int C, float slope,
                                int shift_graph, void* stream) {
  if (B <= 0 || npg <= 0 || epg <= 0 || H <= 0 || C <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = gat_round_smem_bytes(npg, epg, H);
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  const uintptr_t addr = (uintptr_t)xw | (uintptr_t)out | (uintptr_t)ins;
  const bool vec2 = C % 2 == 0 && addr % (2 * elem) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec2 ? launch<float, 2>(dl, sl, mask, al, ar, ae, xw, ins, out, B,
                                   npg, epg, H, C, slope, shift_graph, smem, s)
                : launch<float, 1>(dl, sl, mask, al, ar, ae, xw, ins, out, B,
                                   npg, epg, H, C, slope, shift_graph, smem, s);
  }
  return vec2 ? launch<__nv_bfloat16, 2>(dl, sl, mask, al, ar, ae, xw, ins,
                                         out, B, npg, epg, H, C, slope,
                                         shift_graph, smem, s)
              : launch<__nv_bfloat16, 1>(dl, sl, mask, al, ar, ae, xw, ins,
                                         out, B, npg, epg, H, C, slope,
                                         shift_graph, smem, s);
}
