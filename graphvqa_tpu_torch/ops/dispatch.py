"""Layout dispatch of the edge-to-node aggregation (port of
``graphvqa_tpu/ops/dispatch.py:aggregate_edge_values``; the Pallas opt-in
gate beside it there has no counterpart here)."""
from __future__ import annotations

import torch

from graphvqa_tpu_torch.core.graph import GraphBatch
from graphvqa_tpu_torch.ops.dense import dense_aggregate_edges
from graphvqa_tpu_torch.ops.segment import scatter_edges_to_nodes


def aggregate_edge_values(graph: GraphBatch, edge_values: torch.Tensor,
                          reduce: str = "sum") -> torch.Tensor:
    """Per-edge values [E, D] summed (or meaned) into their destinations ->
    [nodes_pad, D]: the dense path on the dense layout (float32 sums cast
    once), the segment path otherwise (the JAX flat path's rounding)."""
    if graph.has_dense_layout:
        return dense_aggregate_edges(graph, edge_values, reduce=reduce)
    return scatter_edges_to_nodes(edge_values, graph.edge_dst,
                                  graph.nodes_pad, edge_mask=graph.edge_mask,
                                  reduce=reduce)
