// The GINE round's messages and their per-destination sum, backward, for
// Hopper (sm_90a): the vjp of gine_messages.cu.
//
// Replaces no TPU kernel: the JAX package differentiates GINESeq's XLA ops.
// Added with the forward, because autograd through the composite
// (nn/gnn.py:GINESeq) ran a dozen kernels a round over [E, C + D] rows,
// among them a bf16 atomic index_add_ (1.66 ms of a train step at B=200,
// PERF.md §5).
//
// Per graph g, with M the messages' dtype, dz [B*npg, C + D] in M and
// pre_e = M(h[src_e] + edge[e]) recomputed for each real edge:
//   d_edge[e] = dz[dst_e, :C] * 1[pre_e > 0]     (0 at 0; padded rows 0)
//   dh[u]     = dz[u, :C] + sum over real e leaving u of d_edge[e]
//   d_ins[g]  = sum_v dz[v, C:] + 2 * 1[ins[g] > 0] * sum_v indeg(v) dz[v, C:]
// over all npg rows v (padded rows receive the broadcast), sums in float32
// (ops/gine_messages.py:gine_messages_backward_reference).
//
// Bound on the H100 (3.35 TB/s): bytes. dz, h, the real edge rows and ins
// read once, dh, d_edge (every row) and d_ins written once: at B=200,
// npg=64, epg=256, C=300, D=512 in bf16 20.8 + 7.7 + 30.7 + 7.7 + 30.7 +
// 0.4 = ~98 MB, ~29 us.
//
// Design.
//  * A block per (graph, column tile), as the forward's. A dz tile stages
//    the graph's npg rows of dz's first C columns in shared memory; warp 0
//    orders the real edges by source in shared memory, a stable counting
//    sort (__match_any_sync ranks, a warp scan of the counts); then each
//    warp walks a source's edges in edge order, four edge rows in flight:
//    it recomputes the sign of pre, writes d_edge and keeps dh's sum in
//    registers. Padded rows of d_edge are written as zeros.
//  * An ins tile sums dz's ins columns over the graph's rows, a warp's
//    rows in turn, then the warps' sums in warp order.
//  * No atomics on floats, so two runs give the same bits.
//  * Capture-safe as the forward: the caller's stream, the attribute set
//    on an eager launch, the launch counted on the card by block (0, 0).
#include "gine_messages.cuh"

namespace gine {
namespace {

struct Params {
  const int32_t* dl;
  const int32_t* sl;
  const uint8_t* mask;
  const void* h;
  const void* ins;
  const void* edge;
  const void* dz;
  void* dh;
  void* d_edge;
  void* d_ins;
  unsigned long long* launches;
  int npg, epg, C, D;
  int cpt_c, tiles_c, cpt_d;
  int stage_bytes;
};

// Warp 0 of the block: s_bysrc[s_sstart[u] .. s_sstart[u + 1]) lists the
// real edges leaving u in edge order. s_fill [npg] is scratch.
__device__ void order_by_source(const short* s_sl, int n_real, int npg,
                                int* s_sstart, int* s_fill, short* s_bysrc) {
  const int lane = threadIdx.x & 31;
  for (int u = lane; u < npg; u += 32) s_fill[u] = 0;
  __syncwarp();
  for (int base = 0; base < n_real; base += 32) {
    const int k = base + lane;
    const int key = k < n_real ? s_sl[k] : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (k < n_real && lane == __ffs(peers) - 1) s_fill[key] += __popc(peers);
    __syncwarp();
  }
  // exclusive scan of the counts; lane l takes rows [lo, hi)
  const int per = (npg + 31) / 32;
  const int lo = min(lane * per, npg), hi = min(lo + per, npg);
  int sum = 0;
  for (int u = lo; u < hi; ++u) sum += s_fill[u];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  int run = incl - sum;
  for (int u = lo; u < hi; ++u) {
    const int c = s_fill[u];
    s_sstart[u] = s_fill[u] = run;
    run += c;
  }
  if (lane == 31) s_sstart[npg] = incl;
  __syncwarp();
  for (int base = 0; base < n_real; base += 32) {
    const int k = base + lane;
    const int key = k < n_real ? s_sl[k] : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (k < n_real)
      s_bysrc[s_fill[key] + __popc(peers & ((1u << lane) - 1u))] = (short)k;
    __syncwarp();
    if (k < n_real && lane == __ffs(peers) - 1) s_fill[key] += __popc(peers);
    __syncwarp();
  }
}

template <typename TH, typename TE, typename TM, int V>
__device__ __forceinline__ void edge_grad(float (&acc)[V],
                                          const float (&h)[V],
                                          const Vec<TE, V>& e,
                                          const TM* dzs, TE* de) {
  const Vec<TM, V> g = *reinterpret_cast<const Vec<TM, V>*>(dzs);
  float out[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float pre = round_to<TM>(h[i] + to_f32(e.v[i]));
    out[i] = pre <= 0.f ? 0.f : to_f32(g.v[i]);  // relu's: 0 where out is 0
    acc[i] += out[i];
  }
  st<TE, V>(de, out);
}

template <typename TH, typename TE, typename TM, int V>
__global__ void __launch_bounds__(kThreads)
gine_messages_backward_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  TM* s_dz = reinterpret_cast<TM*>(smem);
  unsigned char* rest = smem + p.stage_bytes;
  int* s_dstart = reinterpret_cast<int*>(rest);
  int* s_dend = s_dstart + p.npg;
  int* s_fill = s_dend + p.npg;
  int* s_sstart = s_fill + p.npg;                       // npg + 1
  short* s_dl = reinterpret_cast<short*>(
      rest + round16(sizeof(int) * (4 * p.npg + 1)));
  short* s_sl = s_dl + p.epg;
  short* s_bysrc = s_sl + p.epg;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&
      p.launches != nullptr)
    atomicAdd(p.launches, 1ull);
  const int g = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = p.C + p.D;
  const int sw = p.cpt_c * V;
  const bool dz_tile = (int)blockIdx.y < p.tiles_c;
  const int ch = dz_tile ? blockIdx.y * p.cpt_c + lane
                         : (blockIdx.y - p.tiles_c) * p.cpt_d + lane;
  const bool active = dz_tile ? lane < p.cpt_c && ch * V < p.C
                              : lane < p.cpt_d && ch * V < p.D;
  const int col = ch * V;
  const TM* dz = static_cast<const TM*>(p.dz) + (size_t)g * p.npg * W;
  if (dz_tile && active)
    for (int r = warp; r < p.npg; r += kWarps)
      *reinterpret_cast<Vec<TM, V>*>(s_dz + r * sw + lane * V) =
          ld<TM, V>(dz + (size_t)r * W + col);
  const int n_real = stage_graph(p.dl, p.sl, p.mask, g, p.npg, p.epg, s_dl,
                                 s_sl, s_dstart, s_dend);
  if (dz_tile) {
    if (warp == 0)
      order_by_source(s_sl, n_real, p.npg, s_sstart, s_fill, s_bysrc);
    __syncthreads();
    if (!active) return;
    const size_t row0 = (size_t)g * p.npg * p.C + col;
    const TH* h = static_cast<const TH*>(p.h) + row0;
    TH* dh = static_cast<TH*>(p.dh) + row0;
    const size_t edge0 = (size_t)g * p.epg * p.C + col;
    const TE* e = static_cast<const TE*>(p.edge) + edge0;
    TE* de = static_cast<TE*>(p.d_edge) + edge0;
    const TM* dzs = s_dz + lane * V;
    for (int u = warp; u < p.npg; u += kWarps) {
      const int j1 = s_sstart[u + 1];
      int j = s_sstart[u];
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      if (j < j1) {
        float hu[V];
        floats(ld<TH, V>(h + (size_t)u * p.C), hu);
        for (; j + 4 <= j1; j += 4) {
          Vec<TE, V> ev[4];
          int k[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            k[q] = s_bysrc[j + q];
            ev[q] = ld<TE, V>(e + (size_t)k[q] * p.C);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
            edge_grad<TH, TE, TM, V>(acc, hu, ev[q], dzs + s_dl[k[q]] * sw,
                                     de + (size_t)k[q] * p.C);
        }
        for (; j < j1; ++j) {
          const int k = s_bysrc[j];
          edge_grad<TH, TE, TM, V>(acc, hu, ld<TE, V>(e + (size_t)k * p.C),
                                   dzs + s_dl[k] * sw, de + (size_t)k * p.C);
        }
      }
      float own[V], out[V];
      floats(*reinterpret_cast<const Vec<TM, V>*>(dzs + u * sw), own);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = own[i] + acc[i];
      st<TH, V>(dh + (size_t)u * p.C, out);
    }
    // padded edges give nothing back
    float zero[V];
#pragma unroll
    for (int i = 0; i < V; ++i) zero[i] = 0.f;
    for (int k = n_real + warp; k < p.epg; k += kWarps)
      st<TE, V>(de + (size_t)k * p.C, zero);
    return;
  }
  float a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = b[i] = 0.f;
  if (active)
    for (int v = warp; v < p.npg; v += kWarps) {
      const float deg = (float)(s_dend[v] - s_dstart[v]);
      float x[V];
      floats(ld<TM, V>(dz + (size_t)v * W + p.C + col), x);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a[i] += x[i];
        b[i] += __fmul_rn(deg, x[i]);
      }
    }
  // the warps' sums, added in warp order
  float* red = reinterpret_cast<float*>(smem);        // [kWarps][2][32 * V]
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[(warp * 2) * 32 * V + lane * V + i] = a[i];
    red[(warp * 2 + 1) * 32 * V + lane * V + i] = b[i];
  }
  __syncthreads();
  if (warp != 0 || !active) return;
  float sa[V], sb[V], x[V], out[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sa[i] = sb[i] = 0.f;
  for (int w = 0; w < kWarps; ++w)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sa[i] += red[(w * 2) * 32 * V + lane * V + i];
      sb[i] += red[(w * 2 + 1) * 32 * V + lane * V + i];
    }
  floats(ld<TM, V>(static_cast<const TM*>(p.ins) + (size_t)g * p.D + col), x);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = sa[i] + (x[i] > 0.f ? 2.f * sb[i] : 0.f);
  st<TM, V>(static_cast<TM*>(p.d_ins) + (size_t)g * p.D + col, out);
}

template <typename TH, typename TE, typename TM, int V>
int launch(Params p, int B, cudaStream_t stream) {
  auto kernel = gine_messages_backward_kernel<TH, TE, TM, V>;
  static size_t allowed[kMaxDevices];
  int dev = 0;
  size_t limit = 0;
  int err = device_limit(&dev, &limit);
  if (err != 0) return err;
  const size_t fixed = round16(sizeof(int) * (4 * p.npg + 1)) +
                       round16(3 * sizeof(short) * p.epg);
  // the stage also holds the ins tiles' warp sums
  const size_t reduce = (size_t)kWarps * 2 * 32 * V * sizeof(float);
  int tiles_d = 0, cpt = 0;
  size_t stage = 0, unused = 0;
  if (!plan_tiles(p.C, V, p.npg, sizeof(TM), fixed, reduce, limit, &p.cpt_c,
                  &p.tiles_c, &stage) ||
      !plan_tiles(p.D, V, 1, 1, 0, 0, limit, &cpt, &tiles_d, &unused))
    return (int)cudaErrorInvalidValue;
  p.cpt_d = cpt;
  p.stage_bytes = (int)stage;
  const size_t smem = stage + fixed;
  err = allow_smem(kernel, smem, dev, stream, allowed);
  if (err != 0) return err;
  kernel<<<dim3(B, p.tiles_c + tiles_d), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TH, typename TE, typename TM>
int launch_vec(const Params& p, int B, cudaStream_t s) {
  const bool vec = p.C % 4 == 0 && p.D % 4 == 0 &&
                   aligned(p.h, 4 * sizeof(TH)) &&
                   aligned(p.dh, 4 * sizeof(TH)) &&
                   aligned(p.edge, 4 * sizeof(TE)) &&
                   aligned(p.d_edge, 4 * sizeof(TE)) &&
                   aligned(p.ins, 4 * sizeof(TM)) &&
                   aligned(p.d_ins, 4 * sizeof(TM)) &&
                   aligned(p.dz, 4 * sizeof(TM));
  return vec ? launch<TH, TE, TM, 4>(p, B, s) : launch<TH, TE, TM, 1>(p, B, s);
}

}  // namespace
}  // namespace gine

// dh [B*npg, C] in th, d_edge [B*epg, C] in te and d_ins [B, D] in tm from
// dz [B*npg, C + D] in tm and the forward's inputs, as
// gine_messages_launch takes them. Launches on the current device and
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int gine_messages_backward_launch(
    int th, int te, int tm, const void* dl, const void* sl, const void* mask,
    const void* h, const void* ins, const void* edge, const void* dz,
    void* dh, void* d_edge, void* d_ins, void* launches, int B, int npg,
    int epg, int C, int D, void* stream) {
  using namespace gine;
  if (B < 1 || npg < 1 || epg < 1 || C < 1 || D < 1 || npg > kMaxLocal ||
      epg > kMaxLocal || B > 2147483647 / npg)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const int32_t*>(dl), static_cast<const int32_t*>(sl),
           static_cast<const uint8_t*>(mask), h, ins, edge, dz, dh, d_edge,
           d_ins, static_cast<unsigned long long*>(launches), npg, epg, C, D,
           0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm == 1)
    return th == 1 && te == 1 ? launch_vec<bf16, bf16, bf16>(p, B, s)
                              : (int)cudaErrorInvalidValue;
  if (tm != 0) return (int)cudaErrorInvalidValue;
  if (th == 0 && te == 0) return launch_vec<float, float, float>(p, B, s);
  if (th == 0 && te == 1) return launch_vec<float, bf16, float>(p, B, s);
  if (th == 1 && te == 0) return launch_vec<bf16, float, float>(p, B, s);
  if (th == 1 && te == 1) return launch_vec<bf16, bf16, float>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
