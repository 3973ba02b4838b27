// Backward of the fused GAT round (csrc/gat_round.cu), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff of
// graphvqa_tpu/ops/dense.py:dense_gat_aggregate (no custom_vjp, and the
// Pallas kernel has no backward). This kernel computes that vjp directly.
//
// Per graph b, head h, edge e (src s -> dst d, real when mask > 0), with the
// forward's terms recomputed from its inputs (nothing is saved but them):
//   z = al[s] + ar[d] + ae[e],  lg = leaky(z),  sh = lg - shift (a constant,
//   JAX's stop_gradient),  p = exp(min(sh, 0)),  den[d] = sum_{e'->d} p,
//   r = (1/H) / (den + 1e-16),  A = p * k * r   (k: dropout scale or 1)
//   u[e]  = <g[d], xw[s,h] + ins[b,h]>
//   dp[e] = k r u[e] - sum_{e'->d} u[e'] A[e'] / (den + 1e-16)
//   dz[e] = dp p t leaky'(z),  t = 0.5 where sh == 0 else 1: JAX's derivative
//           of minimum(sh, 0) at a tie, which the reference's gradient has
//   d_ae = dz,  d_ar[d] = sum_{e->d} dz,  d_al[s] = sum_{e: src s} dz
//   d_xw[s,h] = sum_{e: src s} A[e,h] g[d(e)]
//   d_ins[b,h] = sum_d (sum_{e->d} A[e,h]) g[d]
// Padded edges and rows get exact zeros; every output is written in full.
//
// Bound on the H100 (80 GB HBM3, 3.35 TB/s): bytes. d_xw [B*npg, H, C] is
// written in full (78.6 MB of the ~110 MB least bytes at the main shapes in
// bf16, chip_smoke.py counts it); the ~4*H*C flops per real edge are
// ~0.27 GFLOP. Design: the simple one, right first. One 256-thread block per
// graph; the graph's indices, scores and per-edge terms in shared memory;
// xw, ins and g read from global memory (each g element once for up to 4
// heads); d_xw rows past the last real source zero-filled with 16-byte
// stores. It runs far from its bound: clock64 stamps put 55 % of a block's
// cycles in the u dot products (one warp per edge, loads one after another)
// and 18 % in d_xw, and the block of the largest graph sets the kernel's
// time (PERF.md). Staging the rows in shared memory 32 channels at a
// time, with plain loads, did not help (the staging waits on HBM as the
// dot products did): asynchronous, double-buffered copies and a balance of
// work across blocks are the next steps.
// Everything is local to one graph, so no float atomics: a destination's sums
// run over its run of in-edges in edge order (the dense packing sorts edges
// by destination), a source's over a counting sort of its out-edges in edge
// order, dot products over fixed warp reductions. Two runs agree bit for bit.
// Precondition (as the forward): real edges first, dst-sorted, padding last;
// a device assert stops the kernel on anything else.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-16f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kHeadChunk = 4;   // heads accumulated together per g load

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Shared-memory layout, the same on the host and in the kernel.
struct Layout {
  size_t dl, sl, order, beg, end, sbeg, cur, redi;   // ints
  size_t z, pe, a, u;                                // [epg, H] f32
  size_t m, den, v, rs, red;                         // [npg, H] f32, ...
  size_t total;
  __host__ __device__ Layout(int npg, int epg, int H) {
    size_t o = 0;
    dl = o;    o += round16(sizeof(int) * epg);
    sl = o;    o += round16(sizeof(int) * epg);
    order = o; o += round16(sizeof(int) * epg);
    beg = o;   o += round16(sizeof(int) * npg);
    end = o;   o += round16(sizeof(int) * npg);
    sbeg = o;  o += round16(sizeof(int) * (npg + 1));
    cur = o;   o += round16(sizeof(int) * npg);
    redi = o;  o += round16(sizeof(int) * 2 * kWarps);
    z = o;     o += round16(sizeof(float) * epg * H);
    pe = o;    o += round16(sizeof(float) * epg * H);
    a = o;     o += round16(sizeof(float) * epg * H);
    u = o;     o += round16(sizeof(float) * epg * H);
    m = o;     o += round16(sizeof(float) * npg * H);
    den = o;   o += round16(sizeof(float) * npg * H);
    v = o;     o += round16(sizeof(float) * npg * H);
    rs = o;    o += round16(sizeof(float) * npg * H);
    red = o;   o += round16(sizeof(float) * kWarps * H);
    total = o;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// n elements of zeros from p, 16 bytes per store where aligned.
template <typename T>
__device__ __forceinline__ void zero_fill(T* p, int64_t n) {
  const int64_t to16 =
      (int64_t)((16 - ((uintptr_t)p & 15)) & 15) / (int64_t)sizeof(T);
  const int64_t head = n < to16 ? n : to16;
  const int64_t vecs = (n - head) * (int64_t)sizeof(T) / 16;
  const int64_t tail = head + vecs * 16 / (int64_t)sizeof(T);
  for (int64_t i = threadIdx.x; i < head; i += kThreads) store1(p + i, 0.f);
  uint4* mid = reinterpret_cast<uint4*>(p + head);
  for (int64_t i = threadIdx.x; i < vecs; i += kThreads)
    mid[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = tail + threadIdx.x; i < n; i += kThreads)
    store1(p + i, 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

struct Params {
  const int32_t* dl;
  const int32_t* sl;
  const float* mask;
  const float* al;
  const float* ar;
  const float* ae;
  const float* keep;   // null: no dropout
  const void* xw;
  const void* ins;     // null: no instruction share
  const void* g;       // upstream gradient of out [B*npg, C]
  void* dxw;
  float* dal;
  float* dar;
  float* dae;
  void* dins;          // null when ins is
  int npg, epg, H, C, shift_graph;
  float slope;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gat_round_backward_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npg = p.npg, epg = p.epg, H = p.H, C = p.C;
  const Layout L(npg, epg, H);
  int* dl = reinterpret_cast<int*>(smem + L.dl);      // -1 on padded edges
  int* sl = reinterpret_cast<int*>(smem + L.sl);
  int* order = reinterpret_cast<int*>(smem + L.order);  // edges by source
  int* beg = reinterpret_cast<int*>(smem + L.beg);    // dst runs
  int* end = reinterpret_cast<int*>(smem + L.end);
  int* sbeg = reinterpret_cast<int*>(smem + L.sbeg);  // source ranges
  int* cur = reinterpret_cast<int*>(smem + L.cur);
  int* redi = reinterpret_cast<int*>(smem + L.redi);
  float* zz = reinterpret_cast<float*>(smem + L.z);   // z
  float* pe = reinterpret_cast<float*>(smem + L.pe);  // lg, then p
  float* aa = reinterpret_cast<float*>(smem + L.a);   // A
  float* uu = reinterpret_cast<float*>(smem + L.u);   // u, then dz
  float* mm = reinterpret_cast<float*>(smem + L.m);   // shift per (d, h)
  float* dn = reinterpret_cast<float*>(smem + L.den);
  float* vv = reinterpret_cast<float*>(smem + L.v);   // <g[d], ins[h]>
  float* rs = reinterpret_cast<float*>(smem + L.rs);  // row sums of A
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* __restrict__ xw = static_cast<const T*>(p.xw) + b * npg * H * C;
  const T* __restrict__ ins =
      p.ins == nullptr ? nullptr : static_cast<const T*>(p.ins) + b * H * C;
  const T* __restrict__ g = static_cast<const T*>(p.g) + b * npg * C;
  T* __restrict__ dxw = static_cast<T*>(p.dxw) + b * npg * H * C;
  T* __restrict__ dins =
      p.dins == nullptr ? nullptr : static_cast<T*>(p.dins) + b * H * C;
  const float* __restrict__ al = p.al + b * npg * H;
  const float* __restrict__ ar = p.ar + b * npg * H;
  const float* __restrict__ ae = p.ae + b * epg * H;
  const float* __restrict__ keep =
      p.keep == nullptr ? nullptr : p.keep + b * epg * H;
  float* __restrict__ dal = p.dal + b * npg * H;
  float* __restrict__ dar = p.dar + b * npg * H;
  float* __restrict__ dae = p.dae + b * epg * H;
  const float inv_h = 1.f / (float)H;

  // 1. indices (an index outside [0, npg) or mask <= 0 is padding)
  for (int e = tid; e < epg; e += kThreads) {
    const int s = p.sl[b * epg + e], d = p.dl[b * epg + e];
    const bool real =
        p.mask[b * epg + e] > 0.f && s >= 0 && s < npg && d >= 0 && d < npg;
    dl[e] = real ? d : -1;
    sl[e] = real ? s : -1;
  }
  for (int i = tid; i < npg; i += kThreads) beg[i] = end[i] = cur[i] = 0;
  __syncthreads();

  // 2. destination runs, out-degree per source, last real destination and
  // source
  int md = -1, ms = -1;
  for (int e = tid; e < epg; e += kThreads) {
    const int d = dl[e];
    if (d < 0) continue;
    const int prev = e > 0 ? dl[e - 1] : -1;
    // real edges first and dst-sorted (see the precondition above)
    assert(e == 0 || (prev >= 0 && prev <= d));
    if (prev != d) beg[d] = e;
    if (e + 1 == epg || dl[e + 1] != d) end[d] = e + 1;
    md = max(md, d);
    ms = max(ms, sl[e]);
    atomicAdd(&cur[sl[e]], 1);
  }
  md = warp_max(md);
  ms = warp_max(ms);
  if (lane == 0) redi[warp] = md, redi[kWarps + warp] = ms;
  // logits and their per-head graph max
  for (int e = tid; e < epg; e += kThreads) {
    const int s = sl[e], d = dl[e];
    for (int h = 0; h < H; ++h) {
      float z = 0.f, lg = kNegInf;
      if (d >= 0) {
        z = (al[s * H + h] + ar[d * H + h]) + ae[e * H + h];
        lg = z >= 0.f ? z : p.slope * z;
      }
      zz[e * H + h] = z;
      pe[e * H + h] = lg;
    }
  }
  __syncthreads();
  const int ndst = warp_max(lane < kWarps ? redi[lane] : -1) + 1;
  const int rows = warp_max(lane < kWarps ? redi[kWarps + lane] : -1) + 1;
  if (p.shift_graph) {
    for (int h = 0; h < H; ++h) {
      float m = kNegInf;
      for (int e = tid; e < epg; e += kThreads) m = fmaxf(m, pe[e * H + h]);
      m = warp_max(m);
      if (lane == 0) red[warp * H + h] = m;
    }
  }
  // 3. a counting sort of the real edges by source, stable in edge order
  // (one warp; lanes of one source take consecutive slots in lane order)
  if (tid == 0) {
    sbeg[0] = 0;
    for (int s = 0; s < npg; ++s) {
      sbeg[s + 1] = sbeg[s] + cur[s];
      cur[s] = sbeg[s];
    }
  }
  if (warp == 0) {
    __syncwarp();
    for (int e0 = 0; e0 < epg; e0 += 32) {
      const int e = e0 + lane;
      const int s = e < epg ? sl[e] : -1;
      const unsigned peers = __match_any_sync(~0u, s);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int pos = s >= 0 ? cur[s] + rank : 0;
      __syncwarp();
      if (s >= 0) {
        order[pos] = e;
        if (rank == 0) cur[s] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 4. the forward's softmax terms, one thread per (destination, head)
  for (int q = tid; q < ndst * H; q += kThreads) {
    const int d = q / H, h = q - d * H;
    const int e0 = beg[d], e1 = end[d];
    float den = 0.f, rsum = 0.f, m = kNegInf;
    if (e0 < e1) {
      if (p.shift_graph) {
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w * H + h]);
      } else {
        for (int e = e0; e < e1; ++e) m = fmaxf(m, pe[e * H + h]);
      }
      for (int e = e0; e < e1; ++e) {
        const float ex = expf(fminf(pe[e * H + h] - m, 0.f));
        pe[e * H + h] = ex;
        den += ex;
      }
      const float r = inv_h / (den + kEps);
      for (int e = e0; e < e1; ++e) {
        float ex = pe[e * H + h];
        if (keep != nullptr) ex *= keep[e * H + h];
        const float a = ex * r;
        aa[e * H + h] = a;
        rsum += a;
      }
    }
    mm[q] = m;
    dn[q] = den;
    rs[q] = rsum;
  }
  // <g[d], ins[b, h]> per real destination, one warp each
  if (ins != nullptr) {
    for (int d = warp; d < ndst; d += kWarps) {
      if (beg[d] >= end[d]) continue;
      for (int h0 = 0; h0 < H; h0 += kHeadChunk) {
        float acc[kHeadChunk] = {};
        for (int c = lane; c < C; c += 32) {
          const float gv = to_f32(g[d * C + c]);
#pragma unroll
          for (int j = 0; j < kHeadChunk; ++j)
            if (h0 + j < H) acc[j] += gv * to_f32(ins[(h0 + j) * C + c]);
        }
#pragma unroll
        for (int j = 0; j < kHeadChunk; ++j) {
          const float sum = warp_sum(acc[j]);
          if (lane == 0 && h0 + j < H) vv[d * H + h0 + j] = sum;
        }
      }
    }
  }
  __syncthreads();

  // 5. u[e, h] = <g[d], xw[s, h]> + <g[d], ins[h]>, one warp per real edge
  for (int e = warp; e < epg; e += kWarps) {
    const int d = dl[e], s = sl[e];
    if (d < 0) continue;
    const T* row = xw + s * H * C;
    for (int h0 = 0; h0 < H; h0 += kHeadChunk) {
      float acc[kHeadChunk] = {};
      for (int c = lane; c < C; c += 32) {
        const float gv = to_f32(g[d * C + c]);
#pragma unroll
        for (int j = 0; j < kHeadChunk; ++j)
          if (h0 + j < H) acc[j] += gv * to_f32(row[(h0 + j) * C + c]);
      }
#pragma unroll
      for (int j = 0; j < kHeadChunk; ++j) {
        const float sum = warp_sum(acc[j]);
        const int h = h0 + j;
        if (lane == 0 && h < H)
          uu[e * H + h] = sum + (ins != nullptr ? vv[d * H + h] : 0.f);
      }
    }
  }
  __syncthreads();

  // 6. dz in place of u, and d_ar, one thread per (destination, head)
  for (int q = tid; q < npg * H; q += kThreads) {
    const int d = q / H, h = q - d * H;
    float sum_dz = 0.f;
    if (d < ndst && beg[d] < end[d]) {
      const int e0 = beg[d], e1 = end[d];
      const float den = dn[q], m = mm[q];
      const float r = inv_h / (den + kEps);
      float su = 0.f;
      for (int e = e0; e < e1; ++e) su += uu[e * H + h] * aa[e * H + h];
      const float su_den = su / (den + kEps);
      for (int e = e0; e < e1; ++e) {
        const float k = keep != nullptr ? keep[e * H + h] : 1.f;
        const float dp = k * r * uu[e * H + h] - su_den;
        const float z = zz[e * H + h];
        const float lg = z >= 0.f ? z : p.slope * z;
        const float t = lg - m == 0.f ? 0.5f : 1.f;
        const float dz = dp * pe[e * H + h] * t * (z >= 0.f ? 1.f : p.slope);
        uu[e * H + h] = dz;
        sum_dz += dz;
      }
    }
    dar[q] = sum_dz;
  }
  __syncthreads();

  // 7. d_al over each source's sorted out-edges; d_ae; d_ins; d_xw
  for (int q = tid; q < npg * H; q += kThreads) {
    const int s = q / H, h = q - s * H;
    float acc = 0.f;
    for (int i = sbeg[s]; i < sbeg[s + 1]; ++i) acc += uu[order[i] * H + h];
    dal[q] = acc;
  }
  for (int q = tid; q < epg * H; q += kThreads)
    dae[q] = dl[q / H] >= 0 ? uu[q] : 0.f;
  if (dins != nullptr) {
    for (int q = tid; q < H * C; q += kThreads) {
      const int h = q / C, c = q - h * C;
      float acc = 0.f;
      for (int d = 0; d < ndst; ++d)
        acc += rs[d * H + h] * to_f32(g[d * C + c]);
      store1(dins + q, acc);
    }
  }
  // d_xw: rows past the last real source are 0; in the others one thread
  // per (source, channel) sums every head over the source's out-edges
  zero_fill(dxw + (int64_t)rows * H * C, (int64_t)(npg - rows) * H * C);
  for (int q = tid; q < rows * C; q += kThreads) {
    const int s = q / C, c = q - s * C;
    for (int h0 = 0; h0 < H; h0 += kHeadChunk) {
      float acc[kHeadChunk] = {};
      for (int i = sbeg[s]; i < sbeg[s + 1]; ++i) {
        const int e = order[i];
        const float gv = to_f32(g[dl[e] * C + c]);
#pragma unroll
        for (int j = 0; j < kHeadChunk; ++j)
          if (h0 + j < H) acc[j] += aa[e * H + h0 + j] * gv;
      }
#pragma unroll
      for (int j = 0; j < kHeadChunk; ++j)
        if (h0 + j < H) store1(dxw + (s * H + h0 + j) * C + c, acc[j]);
    }
  }
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = gat_round_backward_kernel<T>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const size_t smem = Layout(p.npg, p.epg, p.H).total;
  // per device: the dynamic shared memory this kernel has been allowed
  static size_t allowed[kMaxDevices];
  if (smem > kSmemDefault && smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  kernel<<<B, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs for these widths, in bytes.
extern "C" size_t gat_round_backward_smem_bytes(int npg, int epg, int H) {
  return Layout(npg, epg, H).total;
}

// dtype: 0 = float32, 1 = bfloat16 (xw, ins, g, dxw and dins). dl/sl int32
// [B, epg] (per graph: real edges first, dst-sorted, padding last), mask f32
// [B, epg], al/ar f32 [B*npg, H], ae f32 [B, epg, H], keep f32 [B, epg, H] or
// null, xw [B*npg, H, C], ins [B, H, C] or null, g [B*npg, C] (the gradient
// of out). Writes dxw [B*npg, H, C], dal/dar f32 [B*npg, H], dae f32
// [B, epg, H] and, when ins is given, dins [B, H, C], each in full. Launches
// on the current device; returns cudaGetLastError() after the launch.
extern "C" int gat_round_backward_launch(
    int dtype, const void* dl, const void* sl, const void* mask,
    const void* al, const void* ar, const void* ae, const void* keep,
    const void* xw, const void* ins, const void* g, void* dxw, void* dal,
    void* dar, void* dae, void* dins, int B, int npg, int epg, int H, int C,
    float slope, int shift_graph, void* stream) {
  if (B <= 0 || npg <= 0 || epg <= 0 || H <= 0 || C <= 0 ||
      (dtype != 0 && dtype != 1) || (ins == nullptr) != (dins == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const int32_t*>(dl), static_cast<const int32_t*>(sl),
           static_cast<const float*>(mask), static_cast<const float*>(al),
           static_cast<const float*>(ar), static_cast<const float*>(ae),
           static_cast<const float*>(keep), xw, ins, g, dxw,
           static_cast<float*>(dal), static_cast<float*>(dar),
           static_cast<float*>(dae), dins, npg, epg, H, C, shift_graph,
           slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, B, s) : launch<__nv_bfloat16>(p, B, s);
}
