// The GINE round's messages and their per-destination sum, forward, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's GINESeq is XLA ops. Added
// because the composite it replaces (nn/gnn.py:GINESeq through
// ops/dense.py's gather and sum) built several [E, C + D] rows a round
// with a dozen memory-bound kernels: 5.5-6.2 ms of a 45 ms train step at
// B=200 (device segment engine_messages, PERF.md §5).
//
// Per graph g of the dense layout (npg node rows, epg edge rows; real
// edges first, sorted by destination), with M the messages' dtype:
//   z[v, :C] = h[v] + M(sum over real e -> v of relu(M(h[src_e] + edge[e])))
//   z[v, C:] = ins[g] + M(indeg(v) * relu(M(ins[g] + ins[g])))
// each sum in float32, rounded where the composite rounds (ops/
// gine_messages.py:gine_messages_reference).
//
// Bound on the H100 (3.35 TB/s): bytes. h, edge and ins read once and z
// written once: at B=200, npg=64, epg=256, C=300, D=512 in bf16, 7.7 +
// 30.7 + 0.2 + 20.8 = 59.4 MB, ~18 us (less where edge rows are padding,
// which is never read). A few float operations a byte.
//
// Design.
//  * The ins half takes no edge row: a real edge's message there is
//    relu(2 ins[g]), so the sum is indeg(v) times it, exact in float32 for
//    bf16 values and so the composite's bits.
//  * A block per (graph, column tile): blockIdx.y < tiles_c takes a tile
//    of h's C columns, the others a tile of the D ins columns. A tile is
//    up to 32 chunks of V columns (V = 4 where the widths and pointers
//    allow, else 1), a lane each; warps take destinations in turn.
//  * An h tile stages the graph's npg rows of its columns in shared
//    memory, then each warp walks a destination's run of in-edges in edge
//    order, four edge rows in flight, the sums in registers: no atomics,
//    the same bits on every run, padded edges never read. The stage also
//    gives each row's own h for z.
//  * The indices are staged and checked once a block (gine_messages.cuh);
//    a device assert stops the kernel on edges in another order.
//  * Capture-safe: launched on the caller's stream; the shared-memory
//    attribute (above 48 KB, bumped rungs only) is set on an eager launch.
//    Block (0, 0) adds one to a 64-bit word on the card, so a CUDA graph's
//    replay counts its launches.
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
  void* z;
  unsigned long long* launches;
  int npg, epg, C, D;
  int cpt_c, tiles_c, cpt_d;
  int stage_bytes;
};

template <typename TH, typename TE, typename TM, int V>
__device__ __forceinline__ void add_message(float (&acc)[V], const TH* hs,
                                            const Vec<TE, V>& e) {
  const Vec<TH, V> hv = *reinterpret_cast<const Vec<TH, V>*>(hs);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float pre = round_to<TM>(to_f32(hv.v[i]) + to_f32(e.v[i]));
    acc[i] += pre <= 0.f ? 0.f : pre;      // relu, NaN passed on
  }
}

template <typename TH, typename TE, typename TM, int V>
__global__ void __launch_bounds__(kThreads)
gine_messages_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  TH* s_h = reinterpret_cast<TH*>(smem);
  int* s_dstart = reinterpret_cast<int*>(smem + p.stage_bytes);
  int* s_dend = s_dstart + p.npg;
  short* s_dl = reinterpret_cast<short*>(
      smem + p.stage_bytes + round16(2 * sizeof(int) * p.npg));
  short* s_sl = s_dl + p.epg;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&
      p.launches != nullptr)
    atomicAdd(p.launches, 1ull);
  const int g = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = p.C + p.D;
  const int sw = p.cpt_c * V;                       // a staged row's elements
  const bool h_tile = (int)blockIdx.y < p.tiles_c;
  const int ch = h_tile ? blockIdx.y * p.cpt_c + lane
                        : (blockIdx.y - p.tiles_c) * p.cpt_d + lane;
  const bool active = h_tile ? lane < p.cpt_c && ch * V < p.C
                             : lane < p.cpt_d && ch * V < p.D;
  const int col = ch * V;
  if (h_tile && active) {
    const TH* h = static_cast<const TH*>(p.h) + (size_t)g * p.npg * p.C + col;
    for (int r = warp; r < p.npg; r += kWarps)
      *reinterpret_cast<Vec<TH, V>*>(s_h + r * sw + lane * V) =
          ld<TH, V>(h + (size_t)r * p.C);
  }
  stage_graph(p.dl, p.sl, p.mask, g, p.npg, p.epg, s_dl, s_sl, s_dstart,
              s_dend);
  if (!active) return;
  TM* z = static_cast<TM*>(p.z) + (size_t)g * p.npg * W;
  if (h_tile) {
    const TE* e = static_cast<const TE*>(p.edge) + (size_t)g * p.epg * p.C +
                  col;
    const TH* hs = s_h + lane * V;
    for (int v = warp; v < p.npg; v += kWarps) {
      const int k1 = s_dend[v];
      int k = s_dstart[v];
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      for (; k + 4 <= k1; k += 4) {
        Vec<TE, V> ev[4];
        int s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[u] = s_sl[k + u];
          ev[u] = ld<TE, V>(e + (size_t)(k + u) * p.C);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          add_message<TH, TE, TM, V>(acc, hs + s[u] * sw, ev[u]);
      }
      for (; k < k1; ++k)
        add_message<TH, TE, TM, V>(acc, hs + s_sl[k] * sw,
                                   ld<TE, V>(e + (size_t)k * p.C));
      float own[V], out[V];
      floats(*reinterpret_cast<const Vec<TH, V>*>(hs + v * sw), own);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = own[i] + round_to<TM>(acc[i]);
      st<TM, V>(z + (size_t)v * W + col, out);
    }
  } else {
    float x[V], r[V];
    floats(ld<TM, V>(static_cast<const TM*>(p.ins) + (size_t)g * p.D + col),
           x);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float two = round_to<TM>(x[i] + x[i]);
      r[i] = two <= 0.f ? 0.f : two;
    }
    for (int v = warp; v < p.npg; v += kWarps) {
      const int deg = s_dend[v] - s_dstart[v];
      float out[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        out[i] = x[i] + round_to<TM>(
                            deg > 0 ? __fmul_rn((float)deg, r[i]) : 0.f);
      st<TM, V>(z + (size_t)v * W + p.C + col, out);
    }
  }
}

template <typename TH, typename TE, typename TM, int V>
int launch(Params p, int B, cudaStream_t stream) {
  auto kernel = gine_messages_kernel<TH, TE, TM, V>;
  static size_t allowed[kMaxDevices];
  int dev = 0;
  size_t limit = 0;
  int err = device_limit(&dev, &limit);
  if (err != 0) return err;
  const size_t fixed = round16(2 * sizeof(int) * p.npg) +
                       round16(2 * sizeof(short) * p.epg);
  int tiles_d = 0, cpt = 0;
  size_t stage = 0, unused = 0;
  if (!plan_tiles(p.C, V, p.npg, sizeof(TH), fixed, 16, limit, &p.cpt_c,
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
                   aligned(p.edge, 4 * sizeof(TE)) &&
                   aligned(p.ins, 4 * sizeof(TM)) &&
                   aligned(p.z, 4 * sizeof(TM));
  return vec ? launch<TH, TE, TM, 4>(p, B, s) : launch<TH, TE, TM, 1>(p, B, s);
}

}  // namespace
}  // namespace gine

// z [B*npg, C + D] in tm from h [B*npg, C] in th, edge [B*epg, C] in te and
// ins [B, D] in tm (dtype codes 0 float32, 1 bfloat16; tm is bfloat16 only
// where th and te are), dl/sl int32 [B, epg] local indices, mask uint8
// [B, epg] (each graph's real edges first, sorted by destination),
// launches an 8-byte count on this card or null. Launches on the current
// device and `stream`; returns cudaGetLastError() after the launch.
extern "C" int gine_messages_launch(int th, int te, int tm, const void* dl,
                                    const void* sl, const void* mask,
                                    const void* h, const void* ins,
                                    const void* edge, void* z,
                                    void* launches, int B, int npg, int epg,
                                    int C, int D, void* stream) {
  using namespace gine;
  if (B < 1 || npg < 1 || epg < 1 || C < 1 || D < 1 || npg > kMaxLocal ||
      epg > kMaxLocal || B > 2147483647 / npg)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const int32_t*>(dl), static_cast<const int32_t*>(sl),
           static_cast<const uint8_t*>(mask), h, ins, edge, z,
           static_cast<unsigned long long*>(launches), npg, epg, C, D,
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
