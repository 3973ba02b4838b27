// Backward of the fused GAT round (csrc/gat_round.cu), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff of
// graphvqa_tpu/ops/dense.py:dense_gat_aggregate (no custom_vjp, and the
// Pallas kernel has no backward). This kernel computes that vjp directly.
//
// Per graph b, head h, edge e (src s -> dst d, real when mask > 0), with the
// forward's terms recomputed from its inputs (nothing is saved but them):
//   z = al[s] + ar[d] + ae[e],  lg = leaky(z),  sh = lg - shift (a constant,
//   JAX's stop_gradient; the graph shift may be given, as the forward's),  p = exp(min(sh, 0)),  den[d] = sum_{e'->d} p,
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
// Bound on the H100 (80 GB HBM3, 3.35 TB/s): bytes. At the main shapes in
// bf16 (B=512, npg=64, epg=256, H=4, C=300) the least bytes are ~113 MB
// (chip_smoke.py counts them), 78.6 MB of it d_xw [B*npg, H, C], which is
// written in full although ~3/4 of its rows are past a graph's last real
// source; the ~4*H*C flops per real edge are ~0.3 GFLOP.
//
// What held the first version back (PR 3: one 256-thread block per graph,
// rows read from global memory; clock64 stamps in an instrumented copy,
// NVIDIA H100 80GB HBM3, 700 W): 55 % of a block's cycles in the dot
// products u, one warp per edge with every g and xw load waiting on HBM in
// turn; 18 % in d_xw, one thread per (source, channel) loading g[d] from
// global memory per out-edge; and the block of the largest graph took ~1.9x
// the mean block's cycles and set the kernel's time.
//
// Design.
//  * Work unit (graph, head): every term above stays within one head, so
//    B*H units (2,048 at the main shapes) are handed out by a counter to
//    persistent blocks, two per SM (three cap the registers at 80 and
//    spill). A large graph is four units on up to four blocks, so no one
//    block's graph sets the time. Each unit reads g and the graph's indices
//    again, from L2. The counter is scratch memory from the caller, zeroed
//    on the stream before each launch (safe on other streams and in a CUDA
//    graph).
//  * Staged rows, copied asynchronously. A unit's real rows lie in one span
//    (the packing puts real nodes first): xw[b, 0:rows, h, :] (segments of C
//    at a stride of H*C, so cp.async pieces, not one bulk copy) and g[b,
//    0:ndst, :]. Their copy is issued once the unit's row counts are known
//    and lands while the logits, the counting sort and the softmax run. The
//    next unit's indices and head-h scores (two meta stages) are copied while
//    this one computes.
//  * bf16 units whose rows fit the stage run both contractions on the tensor
//    cores (mma.sync m16n8k16, f32 accumulators), from rows staged with an
//    odd number of 16-byte units per row (ldmatrix without bank conflicts):
//    U = G [xw_h; ins_h]^T per (16 destinations x 16 rows) tile, u[e] =
//    U[d(e), s(e)] and v[d] = U[d, rows] read out of the accumulators by
//    shuffles; d_xw = P G with P[s, d] = the sum of A over s's parallel edges
//    to d, split into bf16 hi + lo parts so that d_xw keeps f32 accuracy.
//  * The other units (f32, which stays in full f32 on the CUDA cores, and
//    bf16 graphs too large for the stage) stage their rows packed, in channel
//    chunks of a two-stage ring when they exceed the stage (f32 graphs of
//    more than ~35 + 35 rows, the npg=128 rung): chunk j+1 lands while chunk
//    j computes. u is a sum over channels, accumulated in shared memory in
//    chunk order; d_xw and d_ins are per channel. u: one warp per real
//    destination, g[d] loaded once for four of its rows at a time, the four
//    lane sums reduced together (6 shuffles); d_xw: one thread per (source
//    row, 4 channels) over the source's out-edges, sorted (dst, A) pairs.
//  * d_xw rows past the last real source are zeroed with 16-byte stores, a
//    quarter of the graph's by each of its units, issued before the unit's
//    first barrier wait, so the stores drain while it computes.
// Everything is computed by one unit in a fixed order, so no float atomics:
// a destination's sums run over its run of in-edges in edge order (the dense
// packing sorts edges by destination), a source's over a counting sort of its
// out-edges in edge order, dot products over fixed warp reductions in chunk
// order. Two runs agree bit for bit, whichever block takes a unit.
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
constexpr int kBlocksPerSM = 2;
constexpr int kChunkMin = 8;   // channels: the narrowest chunk of a big unit
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Shared-memory layout, the same on the host and in the kernel: two meta
// stages (one unit's indices, mask, head-h score columns, ins row and
// header), the work arrays, then the row stage.
struct Layout {
  size_t dl, sl, mask, al, ar, ae, keep, ins, hdr, meta;     // in a stage
  size_t order, sd, beg, end, sbeg, cur, redi;               // ints
  size_t z, pe, a, sa, u, m, den, rs, v, red, fixed;         // floats
  __host__ __device__ Layout(int npg, int epg, int C, int elem) {
    size_t o = 0;
    dl = o;    o += round16(sizeof(int) * epg);
    sl = o;    o += round16(sizeof(int) * epg);
    mask = o;  o += round16(sizeof(float) * epg);
    al = o;    o += round16(sizeof(float) * npg);
    ar = o;    o += round16(sizeof(float) * npg);
    ae = o;    o += round16(sizeof(float) * epg);
    keep = o;  o += round16(sizeof(float) * epg);
    ins = o;   o += round16((size_t)elem * C);
    hdr = o;   o += 16;
    meta = o;
    o = 2 * meta;
    order = o; o += round16(sizeof(int) * epg);
    sd = o;    o += round16(sizeof(int) * epg);
    beg = o;   o += round16(sizeof(int) * npg);
    end = o;   o += round16(sizeof(int) * npg);
    sbeg = o;  o += round16(sizeof(int) * (npg + 1));
    cur = o;   o += round16(sizeof(int) * npg);
    redi = o;  o += round16(sizeof(int) * 3 * kWarps);
    z = o;     o += round16(sizeof(float) * epg);
    pe = o;    o += round16(sizeof(float) * epg);
    a = o;     o += round16(sizeof(float) * epg);
    sa = o;    o += round16(sizeof(float) * epg);
    u = o;     o += round16(sizeof(float) * epg);
    m = o;     o += round16(sizeof(float) * npg);
    den = o;   o += round16(sizeof(float) * npg);
    rs = o;    o += round16(sizeof(float) * npg);
    v = o;     o += round16(sizeof(float) * npg);
    red = o;   o += round16(sizeof(float) * kWarps);
    fixed = o;
  }
};

// A row stage that holds every row a unit may stage (npg xw rows and npg g
// rows) at a chunk width of cw channels, with 16 bytes of alignment padding.
__host__ __device__ size_t stage_bytes_for(int npg, int cw, int elem) {
  return round16((size_t)2 * npg * cw * elem + 16);
}
// The least row stage: all C channels at once, or two ring halves of the
// narrowest chunk, whichever is smaller.
__host__ __device__ size_t min_stage_bytes(int npg, int C, int elem) {
  const size_t whole = stage_bytes_for(npg, C, elem);
  const size_t ring = 2 * stage_bytes_for(npg, kChunkMin, elem);
  return whole < ring ? whole : ring;
}

// ---- shared-memory copies (PTX) ----
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
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// `rows` segments of `seg` bytes, `stride` bytes apart in global memory,
// into shared memory `dstride` bytes apart, one warp per segment (plain
// loads for 2-byte alignment).
template <int P>
__device__ __forceinline__ void copy_rows_pieces(char* d, int dstride,
                                                 const char* s, size_t stride,
                                                 int rows, int seg) {
  const int per = seg / P, lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    for (int k = lane; k < per; k += 32) {
      char* to = d + (size_t)r * dstride + k * P;
      const char* from = s + (size_t)r * stride + k * P;
      if constexpr (P >= 4) {
        cp_async<P>(to, from);
      } else {
        *reinterpret_cast<uint16_t*>(to) =
            *reinterpret_cast<const uint16_t*>(from);
      }
    }
  }
}
__device__ __forceinline__ void copy_rows(void* dst, int dstride,
                                          const void* src, size_t stride,
                                          int rows, int seg) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const uintptr_t a = (uintptr_t)d | (uintptr_t)dstride | (uintptr_t)s |
                      (uintptr_t)stride | (uintptr_t)seg;
  if (a % 16 == 0) {
    copy_rows_pieces<16>(d, dstride, s, stride, rows, seg);
  } else if (a % 8 == 0) {
    copy_rows_pieces<8>(d, dstride, s, stride, rows, seg);
  } else if (a % 4 == 0) {
    copy_rows_pieces<4>(d, dstride, s, stride, rows, seg);
  } else {
    copy_rows_pieces<2>(d, dstride, s, stride, rows, seg);
  }
}

// n floats `stride` apart (one head's column of a [rows, H] array).
__device__ __forceinline__ void copy_column(float* dst, const float* src,
                                            int n, int stride) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    cp_async<4>(dst + i, src + (size_t)i * stride);
}

// ---- bf16 tensor-core tiles (mma.sync m16n8k16, f32 accumulators) ----
// Four 8x8 bf16 tiles from shared memory; lane l gives the address of row
// l % 8 of tile l / 8 (16-byte aligned).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}
// c += a (16x16, row-major fragment) * b (16x8, column fragment)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// The tensor-core stage of a bf16 unit, in elements and bytes: X [rows (+1
// for ins), ldx] and G [round16(ndst), ldx] with ldx = round16(C) + 8 (an
// odd number of 16-byte units per row, so ldmatrix is free of bank
// conflicts), then P_hi and P_lo [round16(rows), round16(ndst) + 8].
struct TcStage {
  int ldx, kp, nx, mg, mp, ldp;
  size_t g, phi, plo, bytes;
  __host__ __device__ TcStage(int rows, int ndst, int C, bool with_ins) {
    kp = round_up(C, 16);
    ldx = kp + 8;
    nx = rows + (with_ins ? 1 : 0);
    mg = round_up(ndst, 16);
    mp = round_up(rows, 16);
    ldp = mg + 8;
    g = (size_t)nx * ldx * 2;
    phi = g + (size_t)mg * ldx * 2;
    plo = phi + (size_t)mp * ldp * 2;
    bytes = plo + (size_t)mp * ldp * 2;
  }
};

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
// <x, y[j]> for j < 4 over nvec vectors of VEC channels, by the whole warp
// (y[j] null: 0). x is loaded once for the four. The four lane sums are
// reduced together (a transpose: 6 shuffles, not 20); lane 8 j holds
// <x, y[j]> afterwards.
template <typename T, int VEC>
__device__ __forceinline__ float dot4_warp(const T* x, const T* const* y,
                                           int nvec, int lane) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = lane; k < nvec; k += 32) {
    float xv[VEC];
    load_vec<VEC>(x + k * VEC, xv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (y[j] == nullptr) continue;
      float yv[VEC];
      load_vec<VEC>(y[j] + k * VEC, yv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) a[j] += xv[i] * yv[i];
    }
  }
  // lanes with bit 4 clear keep sums 0 and 1, the others 2 and 3
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float k0 = hi16 ? a[2] : a[0], k1 = hi16 ? a[3] : a[1];
  k0 += __shfl_xor_sync(~0u, hi16 ? a[0] : a[2], 16);
  k1 += __shfl_xor_sync(~0u, hi16 ? a[1] : a[3], 16);
  // lanes with bit 3 clear keep the first of those, the others the second
  float v = hi8 ? k1 : k0;
  v += __shfl_xor_sync(~0u, hi8 ? k0 : k1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
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
__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

struct Meta {  // one unit's staged indices, head-h scores and ins row
  int* dl;     // -1 on padded edges once the unit has scanned them
  int* sl;
  float* mask;
  float* al;   // [npg] column h of alpha_l
  float* ar;
  float* ae;   // [epg] column h of alpha_e
  float* keep;
  unsigned char* ins;   // [C] ins[b, h]
  int* hdr;    // [0]: the unit's index, b * H + h
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
  const void* ins;     // null: no instruction share
  const void* g;       // upstream gradient of out [B*npg, C]
  void* dxw;
  float* dal;
  float* dar;
  float* dae;
  void* dins;          // null when ins is
  int* next;   // units handed out past the first gridDim.x; 0 at launch
  int B, npg, epg, H, C, shift_graph, stage_bytes;
  float slope;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gat_round_backward_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int npg = p.npg, epg = p.epg, H = p.H, C = p.C;
  const int units = p.B * H;
  const size_t elem = sizeof(T);
  const Layout L(npg, epg, C, sizeof(T));
  const T* __restrict__ xw = static_cast<const T*>(p.xw);
  const T* __restrict__ ins = static_cast<const T*>(p.ins);
  const T* __restrict__ g = static_cast<const T*>(p.g);
  T* __restrict__ dxw = static_cast<T*>(p.dxw);
  T* __restrict__ dins = static_cast<T*>(p.dins);
  auto meta = [&](int m) {
    unsigned char* base = smem + m * L.meta;
    return Meta{reinterpret_cast<int*>(base + L.dl),
                reinterpret_cast<int*>(base + L.sl),
                reinterpret_cast<float*>(base + L.mask),
                reinterpret_cast<float*>(base + L.al),
                reinterpret_cast<float*>(base + L.ar),
                reinterpret_cast<float*>(base + L.ae),
                reinterpret_cast<float*>(base + L.keep),
                base + L.ins,
                reinterpret_cast<int*>(base + L.hdr)};
  };
  int* order = reinterpret_cast<int*>(smem + L.order);  // edges by source
  int* sd = reinterpret_cast<int*>(smem + L.sd);        // their dst, A
  float* sa = reinterpret_cast<float*>(smem + L.sa);
  int* beg = reinterpret_cast<int*>(smem + L.beg);      // dst runs
  int* end = reinterpret_cast<int*>(smem + L.end);
  int* sbeg = reinterpret_cast<int*>(smem + L.sbeg);    // source ranges
  int* cur = reinterpret_cast<int*>(smem + L.cur);
  int* redi = reinterpret_cast<int*>(smem + L.redi);
  float* zz = reinterpret_cast<float*>(smem + L.z);     // z
  float* pe = reinterpret_cast<float*>(smem + L.pe);    // lg, then p
  float* aa = reinterpret_cast<float*>(smem + L.a);     // A
  float* uu = reinterpret_cast<float*>(smem + L.u);     // <g, xw>, then dz
  float* mm = reinterpret_cast<float*>(smem + L.m);     // shift per dst
  float* dn = reinterpret_cast<float*>(smem + L.den);
  float* rs = reinterpret_cast<float*>(smem + L.rs);    // row sums of A
  float* vv = reinterpret_cast<float*>(smem + L.v);     // <g[d], ins[h]>
  float* red = reinterpret_cast<float*>(smem + L.red);
  unsigned char* stage = smem + L.fixed;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float inv_h = 1.f / (float)H;

  // Start the copies of unit `unit`'s indices, scores and ins into stage m.
  auto issue_meta = [&](int m, int unit) {
    const Meta M = meta(m);
    const int64_t b = unit / H;
    const int h = unit - (int)b * H;
    copy_async(M.dl, p.dl + b * epg, sizeof(int) * epg);
    copy_async(M.sl, p.sl + b * epg, sizeof(int) * epg);
    copy_async(M.mask, p.mask + b * epg, sizeof(float) * epg);
    copy_column(M.al, p.al + b * npg * H + h, npg, H);
    copy_column(M.ar, p.ar + b * npg * H + h, npg, H);
    copy_column(M.ae, p.ae + b * epg * H + h, epg, H);
    if (p.keep != nullptr)
      copy_column(M.keep, p.keep + b * epg * H + h, epg, H);
    if (ins != nullptr) copy_async(M.ins, ins + (b * H + h) * C, elem * C);
    cp_async_commit();
  };

  if (tid == 0) meta(0).hdr[0] = blockIdx.x;
  issue_meta(0, blockIdx.x);

  for (int k = 0;; ++k) {
    // 0. this unit's indices and scores have landed (copied while the last
    // unit computed)
    cp_async_wait<0>();
    __syncthreads();
    const Meta M = meta(k & 1);
    const int unit = M.hdr[0];
    if (unit >= units) break;
    const int64_t b = unit / H;
    const int h = unit - (int)b * H;

    // 1. real edges (padding marked -1), and the last real edge, source and
    // destination. The next unit goes to the first block that gets here.
    int drawn = 0;
    if (tid == 0) drawn = atomicAdd(p.next, 1);
    for (int i = tid; i < npg; i += kThreads) beg[i] = end[i] = cur[i] = 0;
    int ne = -1, ms = -1, md = -1;
    for (int e = tid; e < epg; e += kThreads) {
      const int s = M.sl[e], d = M.dl[e];
      if (M.mask[e] > 0.f && s >= 0 && s < npg && d >= 0 && d < npg) {
        ne = e;
        ms = max(ms, s);
        md = max(md, d);
      } else {
        M.dl[e] = M.sl[e] = -1;
      }
    }
    ne = warp_max(ne);
    ms = warp_max(ms);
    md = warp_max(md);
    if (lane == 0)
      redi[warp] = ne, redi[kWarps + warp] = ms, redi[2 * kWarps + warp] = md;
    if (tid == 0) meta((k + 1) & 1).hdr[0] = gridDim.x + drawn;
    __syncthreads();
    const int nreal = warp_max(lane < kWarps ? redi[lane] : -1) + 1;
    const int rows = warp_max(lane < kWarps ? redi[kWarps + lane] : -1) + 1;
    const int ndst =
        warp_max(lane < kWarps ? redi[2 * kWarps + lane] : -1) + 1;

    // the next unit's indices, then this unit's rows: xw[b, :rows, h] and
    // g[b, :ndst]; a bf16 unit whose tensor-core stage fits takes that path
    // (ins[h] staged as one more xw row), the others stage their rows
    // packed, in channel chunks of a two-stage ring when they exceed the
    // stage
    const int next = meta((k + 1) & 1).hdr[0];
    if (next < units) issue_meta((k + 1) & 1, next);
    const TcStage ts(rows, ndst, C, ins != nullptr);
    const bool tc = sizeof(T) == 2 && C % 2 == 0 &&
                    (uintptr_t)dxw % 4 == 0 &&
                    ts.bytes <= (size_t)p.stage_bytes;
    const int span = rows + ndst;
    int cw = C;
    size_t half = 0;
    if (!tc && (size_t)span * C * elem + 16 > (size_t)p.stage_bytes) {
      half = ((size_t)p.stage_bytes / 2) & ~(size_t)15;
      cw = (int)((half - 16) / ((size_t)span * elem));
      cw -= cw % kChunkMin;
    }
    const int nchunk = (C + cw - 1) / cw;
    const T* xw_u = xw + (b * npg * H + h) * (int64_t)C;
    const T* g_u = g + b * npg * (int64_t)C;
    auto stage_x = [&](int j) {
      return reinterpret_cast<T*>(stage + (j & 1) * half);
    };
    auto stage_g = [&](int j, int cwid) {
      return reinterpret_cast<T*>(stage + (j & 1) * half +
                                  round16((size_t)rows * cwid * elem));
    };
    auto issue_chunk = [&](int j) {
      const int c0 = j * cw, cwid = min(cw, C - c0), seg = cwid * (int)elem;
      copy_rows(stage_x(j), seg, xw_u + c0, (size_t)H * C * elem, rows, seg);
      copy_rows(stage_g(j, cwid), seg, g_u + c0, (size_t)C * elem, ndst,
                seg);
      cp_async_commit();
    };
    T* const tx = reinterpret_cast<T*>(stage);            // tensor-core X
    T* const tg = reinterpret_cast<T*>(stage + ts.g);     // and G
    if (tc) {
      const int ld = ts.ldx * (int)elem, seg = C * (int)elem;
      copy_rows(tx, ld, xw_u, (size_t)H * C * elem, rows, seg);
      if (ins != nullptr) {   // from the staged meta, which has landed
        const T* from = reinterpret_cast<const T*>(M.ins);
        for (int c = tid; c < C; c += kThreads) tx[rows * ts.ldx + c] = from[c];
      }
      copy_rows(tg, ld, g_u, (size_t)C * elem, ndst, seg);
      cp_async_commit();
    } else {
      issue_chunk(0);
      if (nchunk > 1) issue_chunk(1);
    }
    // d_xw rows past the last real source are 0; each of the graph's H
    // units zeroes its share of them while its copies land
    {
      const int64_t n = (int64_t)(npg - rows) * H * C;
      int64_t lo = n * h / H, hi = n * (h + 1) / H;
      lo &= ~(int64_t)7;
      if (h + 1 < H) hi &= ~(int64_t)7;
      zero_fill(dxw + (b * npg + rows) * H * (int64_t)C + lo, hi - lo);
    }

    // 2. destination runs, out-degrees, the logits of head h and their max
    float mx = kNegInf;
    for (int e = tid; e < nreal; e += kThreads) {
      const int d = M.dl[e], s = M.sl[e];
      const int prev = e > 0 ? M.dl[e - 1] : -1;
      // real edges first and dst-sorted (see the precondition above)
      assert(d >= 0 && (e == 0 || (prev >= 0 && prev <= d)));
      if (prev != d) beg[d] = e;
      if (e + 1 == nreal || M.dl[e + 1] != d) end[d] = e + 1;
      atomicAdd(&cur[s], 1);
      const float z = (M.al[s] + M.ar[d]) + M.ae[e];
      const float lg = z >= 0.f ? z : p.slope * z;
      zz[e] = z;
      pe[e] = lg;
      mx = fmaxf(mx, lg);
    }
    mx = warp_max(mx);
    if (lane == 0) red[warp] = mx;
    __syncthreads();

    // 3. warp 0: each source's range of out-edges (a warp scan of the
    // out-degrees) and a counting sort of the real edges by source, stable
    // in edge order (lanes of one source take consecutive slots in lane
    // order); the other warps: the forward's softmax terms, one thread per
    // real destination
    if (warp == 0) {
      int carry = 0;
      for (int s0 = 0; s0 < npg; s0 += 32) {
        const int s = s0 + lane;
        const int c = s < npg ? cur[s] : 0;
        int x = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(~0u, x, o);
          if (lane >= o) x += y;
        }
        if (s < npg) sbeg[s] = cur[s] = carry + x - c;
        carry += __shfl_sync(~0u, x, 31);
      }
      if (lane == 0) sbeg[npg] = carry;
      __syncwarp();
      for (int e0 = 0; e0 < nreal; e0 += 32) {
        const int e = e0 + lane;
        const int s = e < nreal ? M.sl[e] : -1;
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
    } else {
      for (int d = tid - 32; d < ndst; d += kThreads - 32) {
        const int e0 = beg[d], e1 = end[d];
        float den = 0.f, rsum = 0.f, m = kNegInf;
        if (e0 < e1) {
          if (p.gmax != nullptr) {
            m = p.gmax[b * H + h];
          } else if (p.shift_graph) {
            for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w]);
          } else {
            for (int e = e0; e < e1; ++e) m = fmaxf(m, pe[e]);
          }
          for (int e = e0; e < e1; ++e) {
            const float ex = expf(fminf(pe[e] - m, 0.f));
            pe[e] = ex;
            den += ex;
          }
          const float r = inv_h / (den + kEps);
          for (int e = e0; e < e1; ++e) {
            float ex = pe[e];
            if (p.keep != nullptr) ex *= M.keep[e];
            const float a = ex * r;
            aa[e] = a;
            rsum += a;
          }
        }
        mm[d] = m;
        dn[d] = den;
        rs[d] = rsum;
      }
    }
    __syncthreads();

    // 4. per chunk of channels, from the staged rows:
    //  u[e] += <g[d], xw[s, h]> and v[d] += <g[d], ins[h]>, in chunk order,
    //  one warp per real destination and four of its rows at a time;
    //  d_xw[s, h] = sum over s's out-edges of A[e] g[d(e)], one thread per
    //  (source row, VEC channels); d_ins[h] = sum_d rowsum_A[d] g[d]
    // or, on the tensor-core path, one pass over the whole unit (below)
    auto ins_grad = [&](const T* gs, int ld, int c0, int nv) {
      for (int q = tid; q < nv; q += kThreads) {
        const int c = q * VEC;
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
        for (int d = 0; d < ndst; ++d)
          fma_vec<T, VEC>(gs + d * ld + c, rs[d], acc);
        store_vec<VEC>(dins + (b * H + h) * (int64_t)C + c0 + c, acc);
      }
    };
    if constexpr (sizeof(T) == 2) {
      if (tc) {
        // P[s, d]: the sum of A over s's parallel edges to d (consecutive
        // among s's sorted out-edges, which are dst-sorted), as bf16 hi and
        // lo parts, one thread per source row; zeros in every pad a tile
        // reads: channels [C, kp) of the staged rows, G's rows [ndst, mg)
        __nv_bfloat16* phi = reinterpret_cast<__nv_bfloat16*>(stage + ts.phi);
        __nv_bfloat16* plo = reinterpret_cast<__nv_bfloat16*>(stage + ts.plo);
        const int ldx = ts.ldx, ldp = ts.ldp, kp = ts.kp;
        for (int r = tid; r < ts.mp; r += kThreads) {
          uint4* zh = reinterpret_cast<uint4*>(phi + r * ldp);
          uint4* zl = reinterpret_cast<uint4*>(plo + r * ldp);
          for (int q = 0; q < ldp / 8; ++q)
            zh[q] = zl[q] = make_uint4(0u, 0u, 0u, 0u);
          if (r >= rows) continue;
          float acc = 0.f;
          for (int i = sbeg[r]; i < sbeg[r + 1]; ++i) {
            const int e = order[i], d = M.dl[e];
            acc += aa[e];
            if (i + 1 == sbeg[r + 1] || M.dl[order[i + 1]] != d) {
              const __nv_bfloat16 hi = __float2bfloat16_rn(acc);
              phi[r * ldp + d] = hi;
              plo[r * ldp + d] =
                  __float2bfloat16_rn(acc - __bfloat162float(hi));
              acc = 0.f;
            }
          }
        }
        const int padw = kp - C;
        for (int q = tid; q < (ts.nx + ndst) * padw; q += kThreads) {
          const int r = q / padw, c = C + (q - r * padw);
          T* row = r < ts.nx ? tx + r * ldx : tg + (r - ts.nx) * ldx;
          *reinterpret_cast<uint16_t*>(row + c) = 0;
        }
        for (int q = tid; q < (ts.mg - ndst) * (kp / 8); q += kThreads) {
          const int r = ndst + q / (kp / 8), c = (q % (kp / 8)) * 8;
          *reinterpret_cast<uint4*>(tg + r * ldx + c) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        cp_async_wait<0>();
        __syncthreads();
        // one warp per job: a tile of U = G [xw; ins]^T (16 destinations x
        // 16 rows), then a tile of d_xw = P G (16 sources x 16 channels)
        const int upairs = (ts.nx + 15) / 16, ujobs = ts.mg / 16 * upairs;
        const int xpairs = kp / 16, jobs = ujobs + ts.mp / 16 * xpairs;
        for (int job = warp; job < jobs; job += kWarps) {
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          if (job < ujobs) {
            const int m0 = job / upairs * 16, n0 = job % upairs * 16;
            const T* ar = tg + (m0 + (lane & 15)) * ldx + (lane >> 4) * 8;
            const int nb = min(n0 + (lane & 7) + (lane >> 4) * 8, ts.nx - 1);
            const T* br = tx + nb * ldx + ((lane >> 3) & 1) * 8;
            for (int k0 = 0; k0 < kp; k0 += 16) {
              uint32_t a[4], bb[4];
              ldsm_x4(a, ar + k0);
              ldsm_x4(bb, br + k0);
              mma_bf16(acc[0], a, bb[0], bb[1]);
              mma_bf16(acc[1], a, bb[2], bb[3]);
            }
            // u[e] = U[d(e), s(e)] over the tile's edges (one run: its
            // destinations' in-edges), v[d] = U[d, rows]; entry (r, c) of
            // the tile is acc[c / 8][2 (r / 8) + c % 2] of lane
            // 4 (r % 8) + (c % 8) / 2
            const int d_hi = min(m0 + 16, ndst);
            int ea = INT_MAX, eb = 0;
            if (m0 + lane < d_hi && beg[m0 + lane] < end[m0 + lane]) {
              ea = beg[m0 + lane];
              eb = end[m0 + lane];
            }
            ea = warp_min(ea);
            eb = warp_max(eb);
            ea = min(ea, eb);
            const int nvd =
                ins != nullptr && n0 <= rows && rows < n0 + 16 ? d_hi - m0
                                                               : 0;
            for (int i0 = ea; i0 < eb + nvd; i0 += 32) {
              const int i = i0 + lane;
              const bool edge = i < eb;
              const int d = edge ? M.dl[i] : m0 + (i - eb);
              const int sc = edge ? M.sl[i] : rows;
              const bool mine = i < eb + nvd && sc >= n0 && sc < n0 + 16;
              const int r = d - m0, c = sc - n0;
              const int owner = mine ? (r & 7) * 4 + ((c & 7) >> 1) : lane;
              const int idx = mine ? (c >> 3) * 4 + (r >> 3) * 2 + (c & 1)
                                   : 0;
              float val = 0.f;
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                const float x = __shfl_sync(~0u, acc[q >> 2][q & 3], owner);
                if (q == idx) val = x;
              }
              if (mine) (edge ? uu[i] : vv[d]) = val;
            }
          } else {
            const int jx = job - ujobs;
            const int m0 = jx / xpairs * 16, n0 = jx % xpairs * 16;
            const int pr = (m0 + (lane & 15)) * ldp + (lane >> 4) * 8;
            const T* br = tg + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldx +
                          n0 + (lane >> 4) * 8;
            for (int k0 = 0; k0 < ts.mg; k0 += 16) {
              uint32_t ah[4], al[4], bb[4];
              ldsm_x4(ah, phi + pr + k0);
              ldsm_x4(al, plo + pr + k0);
              ldsm_x4_trans(bb, br + k0 * ldx);
              mma_bf16(acc[0], ah, bb[0], bb[1]);
              mma_bf16(acc[0], al, bb[0], bb[1]);
              mma_bf16(acc[1], ah, bb[2], bb[3]);
              mma_bf16(acc[1], al, bb[2], bb[3]);
            }
            // lane 4 g + t holds rows m0 + g (+ 8) of channels
            // n0 + 8 q + 2 t (+ 1)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int c = n0 + 8 * q + 2 * (lane & 3);
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int sr = m0 + (lane >> 2) + 8 * hh;
                if (sr < rows && c < C)
                  *reinterpret_cast<__nv_bfloat162*>(
                      dxw + ((b * npg + sr) * H + h) * (int64_t)C + c) =
                      __float22bfloat162_rn(
                          make_float2(acc[q][2 * hh], acc[q][2 * hh + 1]));
              }
            }
          }
        }
        if (dins != nullptr) ins_grad(tg, ldx, 0, C / VEC);
        __syncthreads();
      }
    }
    if (!tc) {
      for (int i = tid; i < nreal; i += kThreads) {
        const int e = order[i];
        sd[i] = M.dl[e];
        sa[i] = aa[e];
      }
    }
    const T* ins_u = reinterpret_cast<const T*>(M.ins);
    for (int j = 0; j < (tc ? 0 : nchunk); ++j) {
      if (j + 1 < nchunk) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int c0 = j * cw, cwid = min(cw, C - c0), nv = cwid / VEC;
      const T* xs = stage_x(j);
      const T* gs = stage_g(j, cwid);
      for (int d = warp; d < ndst; d += kWarps) {
        const int e0 = beg[d], n = end[d] - e0;
        if (n == 0) continue;
        // rows i < n: the in-edges' xw rows; row n: ins[h]
        for (int i0 = 0; i0 < n + (ins != nullptr); i0 += 4) {
          const T* y[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + q;
            y[q] = i < n ? xs + M.sl[e0 + i] * cwid
                         : i == n && ins != nullptr ? ins_u + c0 : nullptr;
          }
          const float sum = dot4_warp<T, VEC>(gs + d * cwid, y, nv, lane);
          const int i = i0 + (lane >> 3);
          if ((lane & 7) == 0 && i <= n) {
            float* acc = i < n ? uu + e0 + i : vv + d;
            if (i < n || ins != nullptr) *acc = (j == 0 ? 0.f : *acc) + sum;
          }
        }
      }
      for (int q = tid; q < rows * nv; q += kThreads) {
        const int s = q / nv, c = (q - s * nv) * VEC;
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
        for (int i = sbeg[s]; i < sbeg[s + 1]; ++i)
          fma_vec<T, VEC>(gs + sd[i] * cwid + c, sa[i], acc);
        store_vec<VEC>(dxw + ((b * npg + s) * H + h) * (int64_t)C + c0 + c,
                       acc);
      }
      if (dins != nullptr) ins_grad(gs, cwid, c0, nv);
      __syncthreads();
      if (j + 2 < nchunk) issue_chunk(j + 2);
    }

    // 5. dz in place of u, and d_ar, one thread per destination
    for (int d = tid; d < npg; d += kThreads) {
      float sum_dz = 0.f;
      if (d < ndst && beg[d] < end[d]) {
        const int e0 = beg[d], e1 = end[d];
        const float den = dn[d], m = mm[d];
        const float r = inv_h / (den + kEps);
        const float vd = ins != nullptr ? vv[d] : 0.f;
        float su = 0.f;
        for (int e = e0; e < e1; ++e) su += (uu[e] + vd) * aa[e];
        const float su_den = su / (den + kEps);
        for (int e = e0; e < e1; ++e) {
          const float kk = p.keep != nullptr ? M.keep[e] : 1.f;
          const float dp = kk * r * (uu[e] + vd) - su_den;
          const float z = zz[e];
          const float lg = z >= 0.f ? z : p.slope * z;
          const float t = lg - m == 0.f ? 0.5f : 1.f;
          const float dz = dp * pe[e] * t * (z >= 0.f ? 1.f : p.slope);
          uu[e] = dz;
          sum_dz += dz;
        }
      }
      p.dar[(b * npg + d) * H + h] = sum_dz;
    }
    __syncthreads();

    // 6. d_al over each source's sorted out-edges; d_ae
    for (int s = tid; s < npg; s += kThreads) {
      float acc = 0.f;
      for (int i = sbeg[s]; i < sbeg[s + 1]; ++i) acc += uu[order[i]];
      p.dal[(b * npg + s) * H + h] = acc;
    }
    for (int e = tid; e < epg; e += kThreads)
      p.dae[(b * epg + e) * H + h] = e < nreal ? uu[e] : 0.f;
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

template <typename T, int VEC>
int launch(Params p, cudaStream_t stream) {
  auto kernel = gat_round_backward_kernel<T, VEC>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const DeviceInfo& info = device_info(dev);
  const Layout L(p.npg, p.epg, p.C, sizeof(T));
  // the row stage: every row a unit may stage, within the share of an SM's
  // shared memory that lets kBlocksPerSM blocks sit on it (or, when the
  // indices and scores leave too little of that, within a block's limit)
  size_t want = L.fixed + stage_bytes_for(p.npg, p.C, sizeof(T));
  if (sizeof(T) == 2) {   // room for the tensor-core stage of a full graph
    const size_t tc = L.fixed + TcStage(p.npg, p.npg, p.C, true).bytes;
    if (tc > want) want = tc;
  }
  const size_t least = min_stage_bytes(p.npg, p.C, sizeof(T));
  size_t smem = (size_t)info.per_sm / kBlocksPerSM - (size_t)info.reserved;
  if (smem < L.fixed + least) smem = (size_t)info.optin;
  if (smem > want) smem = want;
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
  const int64_t units = (int64_t)p.B * p.H;
  const int64_t slots = (int64_t)info.sms * occ_blocks[dev];
  const int grid = (int)(units < slots ? units : slots);
  err = cudaMemsetAsync(p.next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The least shared memory the kernel needs for these widths (a row stage of
// the narrowest channel chunk), in bytes. dtype: 0 = float32, 1 = bfloat16.
extern "C" size_t gat_round_backward_smem_bytes(int npg, int epg, int H,
                                                int C, int dtype) {
  const int elem = dtype == 0 ? 4 : 2;
  (void)H;   // one head per work unit: the layout does not depend on H
  return Layout(npg, epg, C, elem).fixed + min_stage_bytes(npg, C, elem);
}

// dtype: 0 = float32, 1 = bfloat16 (xw, ins, g, dxw and dins). dl/sl int32
// [B, epg] (per graph: real edges first, dst-sorted, padding last), mask f32
// [B, epg], al/ar f32 [B*npg, H], ae f32 [B, epg, H], keep f32 [B, epg, H] or
// null, gmax f32 [B, H] or null (the forward's), xw [B*npg, H, C], ins [B, H, C] or null, g [B*npg, C] (the gradient
// of out). Writes dxw [B*npg, H, C], dal/dar f32 [B*npg, H], dae f32
// [B, epg, H] and, when ins is given, dins [B, H, C], each in full. next: 4
// bytes of scratch (the work counter, zeroed here on the stream; it ends
// holding the number of (graph, head) units handed out, B*H). Launches on
// the current device; returns cudaGetLastError() after the launch.
extern "C" int gat_round_backward_launch(
    int dtype, const void* dl, const void* sl, const void* mask,
    const void* al, const void* ar, const void* ae, const void* keep,
    const void* gmax, const void* xw, const void* ins, const void* g,
    void* dxw, void* dal,
    void* dar, void* dae, void* dins, void* next, int B, int npg, int epg,
    int H, int C, float slope, int shift_graph, void* stream) {
  if (B <= 0 || npg <= 0 || epg <= 0 || H <= 0 || C <= 0 ||
      (int64_t)B * H > INT32_MAX / 2 || (dtype != 0 && dtype != 1) ||
      (ins == nullptr) != (dins == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  // channels per thread: 4 where C and the dxw and dins pointers allow, else
  // 1 (xw, g and ins are read from shared memory, laid out to suit)
  const uintptr_t addr = (uintptr_t)dxw | (uintptr_t)dins;
  const int vec = C % 4 == 0 && addr % (4 * elem) == 0 ? 4 : 1;
  Params p{static_cast<const int32_t*>(dl), static_cast<const int32_t*>(sl),
           static_cast<const float*>(mask), static_cast<const float*>(al),
           static_cast<const float*>(ar), static_cast<const float*>(ae),
           static_cast<const float*>(keep),
           shift_graph ? static_cast<const float*>(gmax) : nullptr, xw, ins,
           g, dxw,
           static_cast<float*>(dal), static_cast<float*>(dar),
           static_cast<float*>(dae), dins, static_cast<int*>(next), B, npg,
           epg, H, C, shift_graph, 0, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec == 4 ? launch<float, 4>(p, s) : launch<float, 1>(p, s);
  return vec == 4 ? launch<__nv_bfloat16, 4>(p, s)
                  : launch<__nv_bfloat16, 1>(p, s);
}
