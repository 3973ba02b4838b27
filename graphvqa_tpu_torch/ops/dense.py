"""Dense per-graph graph ops as plain torch index ops.

Port of ``graphvqa_tpu/ops/dense.py``. The JAX package writes every gather
and scatter as a one-hot incidence matmul, a TPU workaround for serialized
row scatters; on a GPU they are plain ``index_select`` / ``index_add_``. The
semantics are kept: padded edges give and receive nothing, sums accumulate
in float32 and return the input dtype, and the destination softmax and the
weighted scatter round where the JAX functions round.

The GAT round itself is :func:`graphvqa_tpu_torch.ops.gat_round.gat_round`.

Under destination-ownership edge sharding (``graph.edge_group`` set, see
``parallel/edge_sharded.py``) a rank holds the edges of the destinations it
owns. Every destination's softmax is then local, and the destination rows
of the others stay 0; each aggregation ends in
``parallel/collectives.py:assemble_rows``, one all-reduce over the edge
group that turns the ranks' disjoint rows into the replicated node rows.
Gathers read the replicated node arrays as they are. The JAX package
computes only the owned rows (a [B, npg/k] slice) and assembles them the
same way; here the full rows are computed, as the index ops do not care
which rows the edges point at.
"""
from __future__ import annotations

import os

import torch

from graphvqa_tpu_torch.core.graph import GraphBatch
from graphvqa_tpu_torch.parallel.collectives import assemble_rows, pmax

NEG_INF = -1e30
SOFTMAX_EPS = 1e-16  # torch_geometric.utils.softmax denominator

# Softmax stabilizer of the GAT round, read as the JAX package reads it:
# 'graph' (per-graph max, the default) or 'dst' (per-destination max).
SOFTMAX_SHIFT = os.environ.get("GRAPHVQA_SOFTMAX_SHIFT", "graph")


def dense_shapes(graph: GraphBatch):
    B, npg, epg = graph.num_graphs, graph.nodes_per_graph, graph.edges_per_graph
    if npg <= 0 or epg <= 0:
        raise ValueError("dense ops need the uniform dense layout")
    return B, npg, epg


def dense_local_indices(graph: GraphBatch):
    """(dst_local, src_local) as [B, epg] int32, the GAT round's indices."""
    B, npg, epg = dense_shapes(graph)
    dl = (graph.edge_dst % npg).reshape(B, epg).to(torch.int32)
    sl = (graph.edge_src % npg).reshape(B, epg).to(torch.int32)
    return dl.contiguous(), sl.contiguous()


def _real_local(dl, sl, mask, npg):
    """[B, epg] bool: mask > 0 and both local indices inside [0, npg)."""
    return (mask > 0) & (dl >= 0) & (dl < npg) & (sl >= 0) & (sl < npg)


def dense_edges(dl, sl, mask, npg):
    """(real [E] bool, src, dst [E] int64 global rows, 0 on padded edges) of
    the dense layout's [B, epg] local indices and mask (> 0 or true on real
    edges): the hand-written kernels' edges as their plain twins index
    them."""
    dl64, sl64 = dl.long(), sl.long()
    real = _real_local(dl64, sl64, mask, npg)
    base = (torch.arange(dl.shape[0], device=dl.device) * npg)[:, None]
    return (real.reshape(-1), torch.where(real, sl64 + base, 0).reshape(-1),
            torch.where(real, dl64 + base, 0).reshape(-1))


def edges_dst_sorted(dl, sl, mask, npg) -> bool:
    """True when every graph's real edges come first, sorted by destination,
    and its padded edges last (the hand-written kernels' precondition)."""
    real = _real_local(dl, sl, mask, npg)
    d = torch.where(real, dl, -1)
    prev = d[:, :-1]
    return not bool((real[:, 1:] & ((prev < 0) | (prev > d[:, 1:]))).any())


def _masked_edges(graph: GraphBatch, values: torch.Tensor) -> torch.Tensor:
    return torch.where(graph.edge_mask[:, None], values, 0.0)


def dense_gather_src(graph: GraphBatch, values: torch.Tensor) -> torch.Tensor:
    """``values[edge_src]`` -> [E, D]; padded edges give zeros."""
    return _masked_edges(graph, values.index_select(0, graph.edge_src))


def dense_gather_dst(graph: GraphBatch, values: torch.Tensor) -> torch.Tensor:
    """``values[edge_dst]`` -> [E, D]; padded edges give zeros."""
    return _masked_edges(graph, values.index_select(0, graph.edge_dst))


def dense_aggregate_edges(graph: GraphBatch, edge_values: torch.Tensor,
                          reduce: str = "sum") -> torch.Tensor:
    """Sum (or mean) of per-edge values into their destinations -> [N, D],
    accumulated in float32, returned in the input dtype."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce: {reduce}")
    N, D = graph.nodes_pad, edge_values.shape[-1]
    v = _masked_edges(graph, edge_values).float()
    out = torch.zeros(N, D, dtype=torch.float32, device=v.device)
    out.index_add_(0, graph.edge_dst, v)
    if reduce == "mean":
        counts = torch.zeros(N, dtype=torch.float32, device=v.device)
        counts.index_add_(0, graph.edge_dst, graph.edge_mask.float())
        out = out / counts.clamp(min=1.0)[:, None]
    # each destination's count is local (ownership): mean before assembling
    return assemble_rows(out.to(edge_values.dtype), graph.edge_group)


def broadcast_to_nodes(graph: GraphBatch, values: torch.Tensor) -> torch.Tensor:
    """Per-graph [B, D] -> per-node [N, D]. Padded rows get their graph's
    value (consumers mask them)."""
    B, npg, _ = dense_shapes(graph)
    D = values.shape[-1]
    return values[:, None, :].expand(B, npg, D).reshape(B * npg, D)


def broadcast_to_edges(graph: GraphBatch, values: torch.Tensor) -> torch.Tensor:
    """Per-graph [B, D] -> per-edge [E, D]. Padded slots get their graph's
    value (consumers mask them)."""
    B, _, epg = dense_shapes(graph)
    D = values.shape[-1]
    return values[:, None, :].expand(B, epg, D).reshape(B * epg, D)


def dense_segment_softmax(graph: GraphBatch,
                          logits: torch.Tensor) -> torch.Tensor:
    """Softmax of per-edge logits [E, H] over each destination's in-edges
    -> [E, H] in the logits' dtype (torch_geometric.utils.softmax; masked
    edges 0). The stabilizing shift is ``SOFTMAX_SHIFT``'s: one max per
    graph ('graph', the default) or per destination ('dst'), detached as
    JAX's ``stop_gradient`` detaches it; the denominator sums in float32.
    On an edge-sharded batch the graph's max is the edge group's, as in JAX:
    the shard's own would be a valid shift too, but the derivative of 1/2
    that JAX's ``minimum`` gives at the maximum would then fall on another
    edge."""
    B, _, epg = dense_shapes(graph)
    H = logits.shape[-1]
    m = graph.edge_mask[:, None]
    lg = torch.where(m, logits, NEG_INF)
    if SOFTMAX_SHIFT == "graph":
        seg_max = pmax(lg.detach().reshape(B, epg, H).amax(dim=1),
                       graph.edge_group).clamp(min=NEG_INF)
        max_e = seg_max[:, None, :].expand(B, epg, H).reshape(B * epg, H)
    else:
        idx = graph.edge_dst[:, None].expand(-1, H)
        seg_max = lg.new_full((graph.nodes_pad, H), NEG_INF).scatter_reduce(
            0, idx, lg.detach(), reduce="amax")
        max_e = seg_max.index_select(0, graph.edge_dst)
    shifted = torch.where(m, lg - max_e, 0.0)
    # minimum, not clamp: its derivative at the tie is 1/2, as in JAX
    expd = torch.where(m, torch.exp(torch.minimum(
        shifted, torch.zeros_like(shifted))), 0.0)
    denom = torch.zeros(graph.nodes_pad, H, dtype=torch.float32,
                        device=logits.device)
    denom.index_add_(0, graph.edge_dst, expd.float())
    alpha = expd / (denom.index_select(0, graph.edge_dst) + SOFTMAX_EPS)
    return torch.where(m, alpha, 0.0).to(logits.dtype)


def dense_scatter_matmul(graph: GraphBatch, edge_weights: torch.Tensor,
                         values: torch.Tensor) -> torch.Tensor:
    """``out[dst] = sum over edges src -> dst of w[e] * values[src]``:
    edge_weights [E, H], values [N, H, C] -> [N, H, C] in the values' dtype.

    The rounding points are JAX's: the masked weights are cast to the
    values' dtype, parallel (src, dst) edges sum into a per-graph matrix P
    [B, H, npg, npg] in float32 (an ``index_add_``, no one-hot operand), P
    is cast to the values' dtype, the product P @ values accumulates in
    float32 and is cast back."""
    N, H, C = values.shape
    B, npg, epg = dense_shapes(graph)
    dt = values.dtype
    w = torch.where(graph.edge_mask[:, None], edge_weights, 0.0).to(dt)
    dl = graph.edge_dst % npg
    sl = graph.edge_src % npg
    b = torch.arange(B, device=dl.device).repeat_interleave(epg)
    heads = torch.arange(H, device=dl.device)
    cell = ((b[:, None] * H + heads) * npg + dl[:, None]) * npg + sl[:, None]
    p = torch.zeros(B * H * npg * npg, dtype=torch.float32, device=dl.device)
    p.index_add_(0, cell.reshape(-1), w.float().reshape(-1))
    p = p.reshape(B, H, npg, npg).to(dt)
    v = values.reshape(B, npg, H, C).transpose(1, 2)          # [B, H, npg, C]
    out = torch.matmul(p.float(), v.float())                  # f32 accumulate
    return assemble_rows(out.transpose(1, 2).reshape(N, H, C).to(dt),
                         graph.edge_group)


def dense_node_softmax(graph: GraphBatch, values: torch.Tensor) -> torch.Tensor:
    """Softmax over each graph's real nodes -> [N, H]; max-shift, +1e-16 on
    the denominator, padded rows 0 (torch_geometric semantics)."""
    B, npg, _ = dense_shapes(graph)
    H = values.shape[-1]
    m3 = graph.node_mask.reshape(B, npg, 1)
    v = torch.where(m3, values.reshape(B, npg, H), NEG_INF)
    vmax = v.amax(dim=1, keepdim=True).clamp(min=NEG_INF)
    shifted = torch.where(m3, v - vmax, 0.0)
    expd = torch.where(m3, torch.exp(shifted.clamp(max=0.0)), 0.0)
    denom = expd.sum(dim=1, keepdim=True) + SOFTMAX_EPS
    out = torch.where(m3, expd / denom, 0.0)
    return out.reshape(B * npg, H).to(values.dtype)


def dense_graph_layer_norm(graph: GraphBatch, x: torch.Tensor,
                           weight: torch.Tensor, bias: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """Per-graph LayerNorm over nodes x channels jointly, with the reference
    quirks: scalar affine, eps added to the std, count clamped to 1, and the
    ``var > 0`` guard. The statistics run in ``x``'s dtype, as in JAX; the
    float32 scalar affine promotes the result to float32."""
    B, npg, _ = dense_shapes(graph)
    C = x.shape[-1]
    m = graph.node_mask.reshape(B, npg, 1).to(x.dtype)
    xd = x.reshape(B, npg, C) * m
    norm = m.sum(dim=(1, 2), keepdim=True).clamp(min=1.0) * C
    mean = xd.sum(dim=(1, 2), keepdim=True) / norm
    centered = (xd - mean) * m
    var = (centered * centered).sum(dim=(1, 2), keepdim=True) / norm
    pos = var > 0
    std = torch.where(pos, torch.sqrt(torch.where(pos, var, 1.0)), 0.0)
    out = centered / (std + eps)
    out = out.float() * weight.reshape(()) + bias.reshape(())
    out = out * m
    return out.reshape(B * npg, C)


def dense_segment_sum_nodes(graph: GraphBatch,
                            values: torch.Tensor) -> torch.Tensor:
    """Per-graph sum over real nodes -> [B, ...]."""
    B, npg = graph.num_graphs, graph.nodes_per_graph
    mask = graph.node_mask.reshape(values.shape[0], *([1] * (values.ndim - 1)))
    v = torch.where(mask, values, 0)
    return v.reshape(B, npg, *values.shape[1:]).sum(dim=1)
