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
//   p      = exp(min(logit - shift, 0))      shift: graph max or dst max;
//            the graph shift may be given ([B, H]: an edge-sharded batch's
//            max over the edge group, parallel/edge_sharded.py)
//   a      = p * (1/H) / (sum_{e->i} p + 1e-16)
//   out[i] = sum_h sum_{e->i} a[e,h] * xw[j,h,:] + sum_h rowsum_a[i,h] * ins[b,h,:]
//
// Bound on the H100 (80 GB HBM3, 3.35 TB/s; 67 TFLOP/s f32 outside the tensor
// cores). The result depends only on the xw and alpha_l rows of real sources,
// the alpha_r rows of real destinations, the alpha_e rows of real edges, the
// indices, the mask and ins; the output is written in full. On the main
// path's batch (B=512 GQA-shaped graphs at npg=64, epg=256, H=4, C=300:
// 54,075 real edges, 8,511 distinct real sources) that is 44.0 MB in bf16
// (13.1 us) and 85.3 MB in f32 (25.5 us); chip_smoke.py counts it from the
// tensors it runs. The arithmetic is ~2*H*C flops per real edge (0.15 GFLOP,
// ~2 us), so the round is bound by bytes. No tensor cores: the TPU kernel's
// dense P_h @ xw_h over all npg slots would read the padded rows again, and
// the FLOPs are far below the card's rate. (With the rows staged, the
// aggregation below is bound by the issue of its bf16 converts, FMAs and
// shared loads, so an mma over the staged span is a candidate; PERF.md.)
//
// What held the first version (one 256-thread block per graph) back, from
// clock64 stamps per phase in an instrumented copy of it (NVIDIA H100 80GB
// HBM3, 700 W): 91 % of a block's cycles went to the aggregation, where every
// thread chained a shared-memory load of the source index to four dependent
// global loads of xw per in-edge, and each real xw row was fetched once per
// out-edge (~6 times) through L1/L2; the prologue and the softmax took 9 %.
//
// Design.
//  * Only real rows, once, into shared memory. The dense packing puts a
//    graph's real nodes at slots [0, n), so every row a real edge can read
//    lies in rows [b*npg, b*npg + 1 + max real src) of xw: one contiguous
//    span, copied with one 1-D bulk copy (cp.async.bulk, the TMA's 1-D form,
//    completing on an mbarrier) when its address and length are 16-byte
//    aligned, else with cp.async in 16, 8 or 4-byte pieces (plain loads for
//    2-byte alignment). The row count comes from sl and mask in the kernel.
//    Gathers in the aggregation then hit shared memory.
//  * Persistent blocks, two per SM, each with one xw stage (so an SM holds
//    two graphs' rows) and a two-stage ring of indices, scores and ins: the
//    next graph's are copied while this one aggregates, and this graph's xw
//    rows are copied while its logits and softmax run. Two blocks per SM
//    beat one block with two xw stages (the stamps showed each block's
//    phases bound by their barriers and latencies, which the other block
//    fills). A block takes graph blockIdx.x first and then whichever graph a
//    counter hands it, so blocks that drew small graphs take more of them
//    (the counter is scratch memory from the caller, zeroed on the stream
//    before each launch, so launches on other streams or in a CUDA graph
//    are safe).
//  * A graph whose rows exceed the stage (f32 graphs of more than ~18
//    nodes, the npg=128 rung) is processed in chunks of channels: out[:,
//    c0:c1] needs only xw[:, :, c0:c1], so no partial sum crosses a chunk.
//    Those chunks are copied and used in turn, without overlap. A chunk is
//    a multiple of 8 channels, or of 4 where the indices and scores of the
//    ladder's top rung (npg=512, epg=2048, f32) leave no room for 8.
//  * Prologue in parallel: one thread per edge for the logits, a
//    warp-shuffle max per head for the graph shift, one thread per
//    (destination, head) for the softmax.
//  * Aggregation: one thread per (real destination, vector of VEC channels),
//    f32 accumulators in registers, 8-byte bf16x4 / 16-byte f32x4 stores
//    where C and the pointers allow (one channel otherwise). The rows
//    past the last real destination are zeroed with 16-byte stores, without
//    walking any edge.
// Training extras, both null on the eval path (checked once per graph, never
// inside the aggregation): `keep` [B, epg, H] f32, the per-edge attention
// dropout scale (0 or 1/(1-rate)) that multiplies exp() after the
// denominator, as ops/dense.py:432-436 does; `alpha` [B, epg, H] in xw's
// dtype, the dropped attention exp / (den + 1e-16) (return_alpha's meaning,
// ops/dense.py:499-503), 0 on padded edges. The backward is
// csrc/gat_round_backward.cu.
// Precondition: within each graph the real edges come first, sorted by
// destination, and the padded ones follow. The dense packing
// (core/packing.py:pack_graphs_dense) lays edges out so; a device assert
// stops the kernel on anything else. Every sum runs over a destination's
// run of in-edges in edge order, so results are deterministic (no float
// atomics). A destination with no real in-edges gets 0 (its weights are
// never formed, so 0 * (1/1e-16) is never computed). Edges whose local
// index falls outside [0, npg) are treated as padding, as the JAX one-hot
// incidence drops them.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kEps = 1e-16f;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkMin = 8;   // channels: the narrowest chunk of a big graph
// ...unless a stage of kChunkMin channels does not fit a block beside the
// indices and scores (f32 at the ladder's top rung, npg=512 / epg=2048):
// then chunks are multiples of kChunkNarrow channels
constexpr int kChunkNarrow = 4;
constexpr int kMaxDevices = 64;
// how a graph's xw rows reach its stage
constexpr int kNone = 0, kBulk = 1, kCopy = 2, kChunked = 3;

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Shared-memory layout, the same on the host and in the kernel: two meta
// stages (indices, mask, scores, ins, run bounds and a header per graph),
// the work arrays and the mbarrier, then the xw stage.
struct Layout {
  size_t dl, sl, mask, ae, al, ar, ins, beg, end, hdr, meta;  // in a stage
  size_t rowsum, red, redi, bar, fixed;                       // from smem
  __host__ __device__ Layout(int npg, int epg, int H, int C, int elem) {
    size_t o = 0;
    dl = o;   o += round16(sizeof(int) * epg);
    sl = o;   o += round16(sizeof(int) * epg);
    mask = o; o += round16(sizeof(float) * epg);
    ae = o;   o += round16(sizeof(float) * epg * H);
    al = o;   o += round16(sizeof(float) * npg * H);
    ar = o;   o += round16(sizeof(float) * npg * H);
    ins = o;  o += round16((size_t)elem * H * C);
    beg = o;  o += round16(sizeof(int) * npg);
    end = o;  o += round16(sizeof(int) * npg);
    hdr = o;  o += 16;
    meta = o;
    o = 2 * meta;
    rowsum = o; o += round16(sizeof(float) * npg * H);
    red = o;    o += round16(sizeof(float) * kWarps * H);
    redi = o;   o += round16(sizeof(int) * kWarps * 2);
    bar = o;    o += 16;
    fixed = o;
  }
};

__host__ __device__ size_t min_stage_bytes(int npg, int H, int C, int elem,
                                           int chunk = kChunkMin) {
  return round16((size_t)npg * H * (C < chunk ? C : chunk) * elem);
}

// ---- shared-memory pipeline primitives (PTX) ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(BYTES) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `nbytes` (even) from global to shared by the whole block, in the widest
// cp.async pieces that both addresses and the length allow.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           size_t nbytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const uintptr_t a = (uintptr_t)d | (uintptr_t)s | (uintptr_t)nbytes;
  if (a % 16 == 0) {
    for (size_t i = 16 * threadIdx.x; i < nbytes; i += 16 * kThreads)
      cp_async<16>(d + i, s + i);
  } else if (a % 8 == 0) {
    for (size_t i = 8 * threadIdx.x; i < nbytes; i += 8 * kThreads)
      cp_async<8>(d + i, s + i);
  } else if (a % 4 == 0) {
    for (size_t i = 4 * threadIdx.x; i < nbytes; i += 4 * kThreads)
      cp_async<4>(d + i, s + i);
  } else {
    for (size_t i = 2 * threadIdx.x; i < nbytes; i += 2 * kThreads)
      *reinterpret_cast<uint16_t*>(d + i) =
          *reinterpret_cast<const uint16_t*>(s + i);
  }
}

// Channels [c0, c0 + cw) of rows [0, rows) of a graph's xw ([rows, H, C])
// into a stage laid out [rows, H, cw].
template <int P>
__device__ __forceinline__ void copy_chunk_pieces(char* d, const char* s,
                                                  int segs, int seg_bytes,
                                                  int row_bytes) {
  const int per = seg_bytes / P;
  for (int i = threadIdx.x; i < segs * per; i += kThreads) {
    const int g = i / per, k = i - g * per;
    char* to = d + (size_t)g * seg_bytes + k * P;
    const char* from = s + (size_t)g * row_bytes + k * P;
    if constexpr (P >= 4) {
      cp_async<P>(to, from);
    } else {
      *reinterpret_cast<uint16_t*>(to) =
          *reinterpret_cast<const uint16_t*>(from);
    }
  }
}
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* xw_g, int rows,
                                           int H, int C, int c0, int cw) {
  const int seg = cw * (int)sizeof(T), row = C * (int)sizeof(T);
  const char* s = reinterpret_cast<const char*>(xw_g + c0);
  char* d = reinterpret_cast<char*>(dst);
  const uintptr_t a = (uintptr_t)s | (uintptr_t)seg | (uintptr_t)row;
  const int segs = rows * H;
  if (a % 16 == 0) {
    copy_chunk_pieces<16>(d, s, segs, seg, row);
  } else if (a % 8 == 0) {
    copy_chunk_pieces<8>(d, s, segs, seg, row);
  } else if (a % 4 == 0) {
    copy_chunk_pieces<4>(d, s, segs, seg, row);
  } else {
    copy_chunk_pieces<2>(d, s, segs, seg, row);
  }
}

// ---- value loads and stores, VEC channels at a time ----
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = *p;
  }
}
// bf16 -> f32 is the bf16 bits in the top half: one shift or mask each
__device__ __forceinline__ float lo_bf16(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = lo_bf16(x.x), v[1] = hi_bf16(x.x);
    v[2] = lo_bf16(x.y), v[3] = hi_bf16(x.y);
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 4) {
    __nv_bfloat162 lo = __float22bfloat162_rn(make_float2(v[0], v[1]));
    __nv_bfloat162 hi = __float22bfloat162_rn(make_float2(v[2], v[3]));
    uint2 x;
    x.x = *reinterpret_cast<uint32_t*>(&lo);
    x.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = x;
  } else {
    store1(p, v[0]);
  }
}
template <typename T, int VEC>
__device__ __forceinline__ void fma_vec(const T* p, float a, float* acc) {
  float v[VEC];
  load_vec<VEC>(p, v);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] += a * v[k];
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

struct Meta {  // one graph's staged indices, scores and ins
  int* dl;
  int* sl;
  float* mask;
  float* w;   // alpha_e in, then the logits, then the weights [epg, H]
  float* al;
  float* ar;
  unsigned char* ins;
  int* beg;   // [npg] first in-edge of each destination
  int* end;   // [npg] one past its last
  int* hdr;   // [0]: the graph's index
};

struct Params {
  const int32_t* dl;
  const int32_t* sl;
  const float* mask;
  const float* al;
  const float* ar;
  const float* ae;
  const float* keep;   // null: no dropout
  const float* gmax;   // [B, H] the graph shift given, or null
  const void* xw;
  const void* ins;
  void* out;
  void* alpha;         // null: no attention output
  int* next;   // graphs handed out past the first gridDim.x; 0 at launch
  int B, npg, epg, H, C, shift_graph, stage_bytes;
  float slope;
};

// HT: the head count when it is fixed at compile time (the model's 4: one
// 16-byte load fetches an edge's four weights and the head loop is
// straight-line code, -17 % device time in bf16 against a run-time H on an
// NVIDIA H100 80GB HBM3 at 700 W), else 0 and p.H. TRAIN: whether the
// dropout scale and the attention output may be given; the eval variants
// (false) see them as constant nulls, so their checks compile away (with
// run-time checks the eval configuration read ~1 % slower).
template <typename T, int VEC, int HT, bool TRAIN>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gat_round_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int npg = p.npg, epg = p.epg, C = p.C, B = p.B;
  const int H = HT > 0 ? HT : p.H;
  const T* __restrict__ xw = static_cast<const T*>(p.xw);
  const T* __restrict__ ins = static_cast<const T*>(p.ins);
  T* __restrict__ out = static_cast<T*>(p.out);
  T* __restrict__ alpha = TRAIN ? static_cast<T*>(p.alpha) : nullptr;
  const Layout L(npg, epg, H, C, sizeof(T));
  auto meta = [&](int m) {
    unsigned char* base = smem + m * L.meta;
    return Meta{reinterpret_cast<int*>(base + L.dl),
                reinterpret_cast<int*>(base + L.sl),
                reinterpret_cast<float*>(base + L.mask),
                reinterpret_cast<float*>(base + L.ae),
                reinterpret_cast<float*>(base + L.al),
                reinterpret_cast<float*>(base + L.ar),
                base + L.ins,
                reinterpret_cast<int*>(base + L.beg),
                reinterpret_cast<int*>(base + L.end),
                reinterpret_cast<int*>(base + L.hdr)};
  };
  float* rowsum = reinterpret_cast<float*>(smem + L.rowsum);  // [npg, H]
  float* red = reinterpret_cast<float*>(smem + L.red);    // [warps, H]
  int* redi = reinterpret_cast<int*>(smem + L.redi);      // [warps, 2]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  T* xs = reinterpret_cast<T*>(smem + L.fixed);            // the xw stage

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto is_real = [&](const Meta& M, int e) {
    const int s = M.sl[e], d = M.dl[e];
    return M.mask[e] > 0.f && s >= 0 && s < npg && d >= 0 && d < npg;
  };
  const size_t row_bytes = (size_t)H * C * sizeof(T);

  // Start the copies of graph b's indices, scores and ins into stage m.
  auto issue_meta = [&](int m, int64_t b) {
    const Meta M = meta(m);
    copy_async(M.dl, p.dl + b * epg, sizeof(int) * epg);
    copy_async(M.sl, p.sl + b * epg, sizeof(int) * epg);
    copy_async(M.mask, p.mask + b * epg, sizeof(float) * epg);
    copy_async(M.w, p.ae + b * epg * H, sizeof(float) * epg * H);
    copy_async(M.al, p.al + b * npg * H, sizeof(float) * npg * H);
    copy_async(M.ar, p.ar + b * npg * H, sizeof(float) * npg * H);
    if (ins != nullptr)
      copy_async(M.ins, ins + b * H * C, sizeof(T) * H * C);
    cp_async_commit();
  };

  if (tid == 0) {
    mbar_init(bar, 1);
    meta(0).hdr[0] = blockIdx.x;
  }
  issue_meta(0, blockIdx.x);
  uint32_t parity = 0;   // the phase of the mbarrier to wait for next
  const float inv_h = 1.f / (float)H;

  for (int k = 0;; ++k) {
    // 0. this graph's indices have landed (they were copied while the last
    // graph aggregated)
    cp_async_wait_all();
    __syncthreads();
    const Meta M = meta(k & 1);
    const int64_t b = M.hdr[0];
    if (b >= B) break;

    // 1. rows, real destinations and each destination's run of in-edges;
    // then start the copy of the xw rows, which the logits and the softmax
    // below do not need. The next graph goes to the first block that gets
    // here, so blocks that drew small graphs take more of them.
    int drawn = 0;
    if (tid == 0) drawn = atomicAdd(p.next, 1);
    for (int i = tid; i < npg; i += kThreads) M.beg[i] = M.end[i] = 0;
    int ms = -1, md = -1;
    for (int e = tid; e < epg; e += kThreads) {
      if (is_real(M, e)) {
        ms = max(ms, M.sl[e]);
        md = max(md, M.dl[e]);
      }
    }
    ms = warp_max(ms);
    md = warp_max(md);
    if (lane == 0) redi[2 * warp] = ms, redi[2 * warp + 1] = md;
    __syncthreads();
    for (int e = tid; e < epg; e += kThreads) {
      if (!is_real(M, e)) continue;
      const int d = M.dl[e];
      const int prev = e > 0 && is_real(M, e - 1) ? M.dl[e - 1] : -1;
      // real edges first and dst-sorted (see the precondition above)
      assert(e == 0 || (prev >= 0 && prev <= d));
      if (prev != d) M.beg[d] = e;
      if (e + 1 == epg || !is_real(M, e + 1) || M.dl[e + 1] != d)
        M.end[d] = e + 1;
    }
    const T* xw_g = xw + b * npg * H * C;
    ms = warp_max(lane < kWarps ? redi[2 * lane] : -1);
    md = warp_max(lane < kWarps ? redi[2 * lane + 1] : -1);
    const int rows = ms + 1, ndst = md + 1;
    const size_t bytes = rows * row_bytes;
    const int mode = rows == 0                               ? kNone
                     : bytes > (size_t)p.stage_bytes         ? kChunked
                     : ((uintptr_t)xw_g | bytes) % 16 == 0   ? kBulk
                                                             : kCopy;
    if (mode == kBulk && tid == 0) bulk_load(xs, xw_g, (uint32_t)bytes, bar);
    if (mode == kCopy) {
      copy_async(xs, xw_g, bytes);
      cp_async_commit();
    }

    // 2. logits in place of alpha_e, one thread per edge; per-graph max
    float* w = M.w;
    for (int e = tid; e < epg; e += kThreads) {
      const bool real = is_real(M, e);
      const int j = M.sl[e], i = M.dl[e];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float x = kNegInf;
        if (real) {
          x = (M.al[j * H + h] + M.ar[i * H + h]) + w[e * H + h];
          x = x >= 0.f ? x : p.slope * x;
        }
        w[e * H + h] = x;
        if (alpha != nullptr && !real)
          store1(alpha + (b * epg + e) * H + h, 0.f);
      }
    }
    if (p.shift_graph) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float m = kNegInf;
        for (int e = tid; e < epg; e += kThreads) m = fmaxf(m, w[e * H + h]);
        m = warp_max(m);
        if (lane == 0) red[warp * H + h] = m;
      }
    }
    if (tid == 0) meta((k + 1) & 1).hdr[0] = gridDim.x + drawn;
    __syncthreads();

    // 3. destination softmax, one thread per (real destination, head)
    for (int q = tid; q < ndst * H; q += kThreads) {
      const int i = q / H, h = q - i * H;
      const int e0 = M.beg[i], e1 = M.end[i];
      float rs = 0.f;
      if (e0 < e1) {
        float m = kNegInf;
        if (p.gmax != nullptr) {
          m = p.gmax[b * H + h];
        } else if (p.shift_graph) {
          for (int v = 0; v < kWarps; ++v) m = fmaxf(m, red[v * H + h]);
        } else {
          for (int e = e0; e < e1; ++e) m = fmaxf(m, w[e * H + h]);
        }
        float den = 0.f;
        for (int e = e0; e < e1; ++e) {
          const float ex = expf(fminf(w[e * H + h] - m, 0.f));
          w[e * H + h] = ex;
          den += ex;
        }
        const float r = inv_h / (den + kEps);
        const float* keep =
            !TRAIN || p.keep == nullptr ? nullptr : p.keep + b * epg * H;
        for (int e = e0; e < e1; ++e) {
          float ex = w[e * H + h];
          if (keep != nullptr) ex *= keep[e * H + h];
          const float a = ex * r;
          w[e * H + h] = a;
          rs += a;
          if (alpha != nullptr)
            store1(alpha + (b * epg + e) * H + h, ex / (den + kEps));
        }
      }
      rowsum[q] = rs;
    }
    // the next graph's indices and scores come in while this one aggregates
    if (mode == kCopy) cp_async_wait_all();
    const int64_t next = meta((k + 1) & 1).hdr[0];
    if (next < B) issue_meta((k + 1) & 1, next);
    if (mode == kBulk) {
      mbar_wait(bar, parity);
      parity ^= 1u;
    }
    __syncthreads();

    // 4. rows past the last real destination are 0; the rest aggregate
    // from the staged rows, one thread per (destination, channel vector)
    const int64_t node0 = b * npg;
    zero_fill(out + (node0 + ndst) * C, (int64_t)(npg - ndst) * C);
    if (rows > 0) {
      int cw = C;
      if (mode == kChunked) {
        cw = (int)((size_t)p.stage_bytes / ((size_t)rows * H * sizeof(T)));
        cw -= cw % (cw >= kChunkMin ? kChunkMin : kChunkNarrow);
      }
      const T* ins_g = reinterpret_cast<const T*>(M.ins);
      for (int c0 = 0; c0 < C; c0 += cw) {
        const int cwid = min(cw, C - c0);
        if (mode == kChunked) {
          if (c0 > 0) __syncthreads();
          copy_chunk(xs, xw_g, rows, H, C, c0, cwid);
          cp_async_wait_all();
          __syncthreads();
        }
        const int CV = cwid / VEC, rstride = H * cwid;
        for (int q = tid; q < ndst * CV; q += kThreads) {
          const int i = q / CV;
          const int c = (q - i * CV) * VEC;
          const int e0 = M.beg[i], e1 = M.end[i];
          float acc[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
#pragma unroll 2
          for (int e = e0; e < e1; ++e) {
            const T* row = xs + M.sl[e] * rstride + c;
            if constexpr (HT == 4) {
              const float4 a = *reinterpret_cast<const float4*>(w + 4 * e);
              fma_vec<T, VEC>(row, a.x, acc);
              fma_vec<T, VEC>(row + cwid, a.y, acc);
              fma_vec<T, VEC>(row + 2 * cwid, a.z, acc);
              fma_vec<T, VEC>(row + 3 * cwid, a.w, acc);
            } else {
              for (int h = 0; h < H; ++h)
                fma_vec<T, VEC>(row + h * cwid, w[e * H + h], acc);
            }
          }
          if (ins != nullptr) {
            for (int h = 0; h < H; ++h)
              fma_vec<T, VEC>(ins_g + h * C + c0 + c, rowsum[i * H + h], acc);
          }
          store_vec<VEC>(out + (node0 + i) * C + c0 + c, acc);
        }
      }
    }
    __syncthreads();
  }
}

struct DeviceInfo {
  int sms = 0, optin = 0, per_sm = 0, reserved = 0;
};

DeviceInfo& device_info(int dev) {
  static DeviceInfo info[kMaxDevices];
  DeviceInfo& d = info[dev];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&d.per_sm,
                           cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&d.reserved,
                           cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  return d;
}

template <typename T, int VEC, int HT, bool TRAIN>
int launch(Params p, cudaStream_t stream) {
  auto kernel = gat_round_kernel<T, VEC, HT, TRAIN>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const DeviceInfo& info = device_info(dev);
  const Layout L(p.npg, p.epg, p.H, p.C, sizeof(T));
  // the xw stage: every row a graph may have, within the share of an SM's
  // shared memory that lets kBlocksPerSM blocks sit on it (or, when the
  // indices and scores leave too little of that, within a block's limit)
  const size_t want = L.fixed + round16((size_t)p.npg * p.H * p.C * sizeof(T));
  size_t least = min_stage_bytes(p.npg, p.H, p.C, sizeof(T));
  size_t smem = (size_t)info.per_sm / kBlocksPerSM - (size_t)info.reserved;
  if (smem < L.fixed + least) smem = (size_t)info.optin;
  if (smem > want) smem = want;
  if (smem < L.fixed + least)
    least = min_stage_bytes(p.npg, p.H, p.C, sizeof(T), kChunkNarrow);
  if (smem < L.fixed + least) return (int)cudaErrorInvalidValue;
  p.stage_bytes = (int)((smem - L.fixed) & ~(size_t)15);
  // per device: the dynamic shared memory this kernel is allowed, and how
  // many of its blocks fit an SM at that size
  static size_t allowed[kMaxDevices], occ_smem[kMaxDevices];
  static int occ_blocks[kMaxDevices];
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  if (occ_smem[dev] != smem) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    occ_blocks[dev] = blocks > 0 ? blocks : 1;
    occ_smem[dev] = smem;
  }
  const int64_t slots = (int64_t)info.sms * occ_blocks[dev];
  const int grid = (int)(p.B < slots ? p.B : slots);
  err = cudaMemsetAsync(p.next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Three variants per dtype and mode (eval, or training with the dropout
// scale or the attention output): 4 channels per thread with H=4 fixed (the
// main path), 4 channels with any H, and one channel with any H (odd C or
// misaligned pointers, off the main path).
template <typename T>
int launch_vec(int vec, const Params& p, cudaStream_t s) {
  if (p.keep != nullptr || p.alpha != nullptr) {
    if (vec != 4) return launch<T, 1, 0, true>(p, s);
    return p.H == 4 ? launch<T, 4, 4, true>(p, s)
                    : launch<T, 4, 0, true>(p, s);
  }
  if (vec != 4) return launch<T, 1, 0, false>(p, s);
  return p.H == 4 ? launch<T, 4, 4, false>(p, s)
                  : launch<T, 4, 0, false>(p, s);
}

}  // namespace

// The least shared memory the kernel needs for these widths (an xw stage of
// the narrowest channel chunk), in bytes. dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t gat_round_smem_bytes(int npg, int epg, int H, int C,
                                       int dtype) {
  const int elem = dtype == 0 ? 4 : 2;
  return Layout(npg, epg, H, C, elem).fixed +
         min_stage_bytes(npg, H, C, elem, kChunkNarrow);
}

// dtype: 0 = float32, 1 = bfloat16 (xw, ins and out). dl/sl int32 [B, epg]
// (per graph: real edges first, dst-sorted, padding last),
// mask f32 [B, epg], al/ar f32 [B*npg, H], ae f32 [B, epg, H], xw [B*npg, H, C],
// keep f32 [B, epg, H] or null, gmax f32 [B, H] or null (with shift_graph:
// the shift given instead of the graph's max over its edges here), ins
// [B, H, C] or null, out [B*npg, C],
// alpha [B, epg, H] or null, next 4 bytes of scratch (the graph counter,
// zeroed here on the stream). Launches on the current device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gat_round_launch(int dtype, const void* dl, const void* sl,
                                const void* mask, const void* al,
                                const void* ar, const void* ae,
                                const void* keep, const void* gmax,
                                const void* xw,
                                const void* ins, void* out, void* alpha,
                                void* next, int B, int npg, int epg, int H,
                                int C, float slope, int shift_graph,
                                void* stream) {
  if (B <= 0 || npg <= 0 || epg <= 0 || H <= 0 || C <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  // channels per thread: 4 where C and the out and ins pointers allow, else
  // 1 (xw is read from shared memory, laid out to suit)
  const uintptr_t addr = (uintptr_t)out | (uintptr_t)ins;
  const int vec = C % 4 == 0 && addr % (4 * elem) == 0 ? 4 : 1;
  Params p{static_cast<const int32_t*>(dl), static_cast<const int32_t*>(sl),
           static_cast<const float*>(mask), static_cast<const float*>(al),
           static_cast<const float*>(ar), static_cast<const float*>(ae),
           static_cast<const float*>(keep),
           shift_graph ? static_cast<const float*>(gmax) : nullptr, xw, ins,
           out, alpha,
           static_cast<int*>(next), B, npg, epg, H, C, shift_graph, 0, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_vec<float>(vec, p, s)
                    : launch_vec<__nv_bfloat16>(vec, p, s);
}
