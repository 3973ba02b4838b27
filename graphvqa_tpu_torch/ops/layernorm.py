"""Per-graph LayerNorm over nodes x channels jointly (port of
``graphvqa_tpu/ops/layernorm.py``): the dense layout's masked reduce
(``ops/dense.py:dense_graph_layer_norm``) or the flat layout's segment path.

The reference's quirks hold on both: scalar affine, eps added to the std,
the normaliser ``max(num_nodes, 1) * channels``, and the double ``where``
that keeps sqrt'(0) out of the padding segment's gradient. The statistics
run in ``x``'s dtype, as in JAX; the float32 scalar affine promotes the
result to float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from graphvqa_tpu_torch.core.graph import GraphBatch
from graphvqa_tpu_torch.ops.dense import dense_graph_layer_norm
from graphvqa_tpu_torch.ops.segment import segment_sum


def graph_layer_norm_any(graph: GraphBatch, x: torch.Tensor,
                         weight: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """The dense path on the dense layout, the segment path otherwise."""
    if graph.has_dense_layout:
        return dense_graph_layer_norm(graph, x, weight, bias, eps)
    return graph_layer_norm(x, graph.node_graph, graph.num_graphs, weight,
                            bias, node_mask=graph.node_mask, eps=eps)


def graph_layer_norm(x: torch.Tensor, node_graph: torch.Tensor,
                     num_graphs: int, weight: torch.Tensor,
                     bias: torch.Tensor,
                     node_mask: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """x [nodes_pad, C] normalised per graph (``node_graph`` ids, padding
    at ``num_graphs``) with scalar ``weight`` / ``bias``."""
    channels = x.shape[-1]
    num_segments = num_graphs + 1          # one discard segment for padding
    ones = (x.new_ones(x.shape[0], 1) if node_mask is None
            else node_mask.to(x.dtype)[:, None])
    counts = segment_sum(ones, node_graph, num_segments)
    norm = counts.clamp(min=1.0) * channels                  # [S, 1]
    total = segment_sum(x, node_graph, num_segments, mask=node_mask)
    mean = total.sum(dim=-1, keepdim=True) / norm
    centered = x - mean.index_select(0, node_graph)
    if node_mask is not None:
        centered = torch.where(node_mask[:, None], centered, 0.0)
    sq = segment_sum(centered * centered, node_graph, num_segments,
                     mask=node_mask)
    var = sq.sum(dim=-1, keepdim=True) / norm
    pos = var > 0
    std = torch.where(pos, torch.sqrt(torch.where(pos, var, 1.0)), 0.0)
    out = centered / (std.index_select(0, node_graph) + eps)
    out = out.float() * weight.reshape(()) + bias.reshape(())
    if node_mask is not None:
        out = torch.where(node_mask[:, None], out, 0.0)
    return out
