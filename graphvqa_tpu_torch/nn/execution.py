"""The recurrent execution engine and its execution bitmap, the paper's
"explainable" output (port of ``graphvqa_tpu/nn/execution.py``).

Per instruction step: a residual node update conditioned on the
instruction vector and a per-graph history vector, the per-graph
LayerNorm, then a per-node gate softmaxed over each graph's nodes; the gate
is one column of the [N, steps] bitmap and the gated node sum is the next
history. The node features ``x`` themselves are never replaced: every step
starts from the encoded nodes, as in the JAX package. Parameters are named
after the JAX tree (the released reference comments this engine out):
``node_mlp_1``, ``node_mlp_2``, ``bitmap_gate_mlp`` and ``history_mlp`` as
``Seq(Lin, ReLU, Lin)`` and the scalar ``ln_weight`` / ``ln_bias``.
``history_mlp`` runs, but the pipeline reads only the bitmap, so its
parameters get zero gradients, as in JAX.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from graphvqa_tpu_torch.core.graph import GraphBatch
from graphvqa_tpu_torch.nn.gnn import (
    MLP2, gather_src, graph_to_edges, graph_to_nodes)
from graphvqa_tpu_torch.ops import dense
from graphvqa_tpu_torch.ops.dispatch import aggregate_edge_values
from graphvqa_tpu_torch.ops.layernorm import graph_layer_norm_any
from graphvqa_tpu_torch.ops.segment import segment_softmax, segment_sum


class RecurrentExecutionEngine(nn.Module):
    def __init__(self, node_features: int, instr_features: int,
                 max_steps: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        Cn, Ci = node_features, instr_features
        self.max_steps, self.compute_dtype = max_steps, dtype
        self.node_features = Cn
        self.node_mlp_1 = MLP2(2 * Cn, Cn, Cn, dtype)
        self.node_mlp_2 = MLP2(2 * Cn + Ci, Cn, Cn, dtype)
        self.bitmap_gate_mlp = MLP2(Cn, Cn, 1, dtype)
        self.history_mlp = MLP2(Cn, Ci, Ci, dtype)
        self.ln_weight = nn.Parameter(torch.ones(1))
        self.ln_bias = nn.Parameter(torch.zeros(1))

    def forward(self, graph: GraphBatch, x: torch.Tensor,
                instr_vectors: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [N, Cn], instr_vectors [steps, B, Ci] -> (x unchanged, bitmap
        [N, steps], histories [steps, B, Ci])."""
        B = graph.num_graphs
        history = x.new_zeros(B, self.node_features,
                              dtype=self.compute_dtype)
        cols, histories = [], []
        for step in range(self.max_steps):
            # messages [x_src ; history of the edge's graph]
            msg = self.node_mlp_1(torch.cat(
                [gather_src(graph, x), graph_to_edges(graph, history)], dim=-1))
            aggr = aggregate_edge_values(graph, msg, reduce="mean")
            u_nodes = graph_to_nodes(graph, instr_vectors[step])
            x_out = self.node_mlp_2(torch.cat([x, aggr, u_nodes], dim=-1)) + x
            x_out = graph_layer_norm_any(graph, x_out, self.ln_weight,
                                         self.ln_bias)
            gate = self.bitmap_gate_mlp(x_out)                    # [N, 1]
            if graph.has_dense_layout:
                gate = dense.dense_node_softmax(graph, gate)
                history = dense.dense_segment_sum_nodes(graph, gate * x_out)
            else:
                gate = segment_softmax(gate, graph.node_graph, B + 1,
                                       mask=graph.node_mask)
                history = segment_sum(gate * x_out, graph.node_graph, B + 1,
                                      mask=graph.node_mask)[:B]
            cols.append(gate)
            histories.append(history)
        bitmap = torch.cat(cols, dim=1)
        return x, bitmap, self.history_mlp(torch.stack(histories))


def bitmap_precision_recall(bitmap_pred: torch.Tensor,
                            bitmap_true: torch.Tensor,
                            node_mask: torch.Tensor, threshold: float = 0.5):
    """(precision_sum, precision_count, recall_sum, recall_count) of the
    bitmap over real nodes: true positives, predicted positives, true
    positives, actual positives."""
    m = node_mask[:, None]
    pred = (bitmap_pred >= threshold) & m
    true = (bitmap_true >= 0.5) & m
    tp = (pred & true).sum()
    return tp, pred.sum(), tp, true.sum()
