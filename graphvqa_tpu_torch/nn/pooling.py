"""Language-conditioned global attention pooling (port of
``graphvqa_tpu/nn/pooling.py``): gate = MLP(ques_nn(u) * node_nn(x)),
softmaxed over each graph's nodes, then the gate-weighted node sum; the
dense layout's masked reductions or the flat layout's segment ops."""
from __future__ import annotations

import torch
from torch import nn

from graphvqa_tpu_torch.core.graph import GraphBatch
from graphvqa_tpu_torch.nn.gnn import MLP2
from graphvqa_tpu_torch.ops.dense import (
    broadcast_to_nodes, dense_node_softmax, dense_segment_sum_nodes)
from graphvqa_tpu_torch.ops.segment import segment_softmax, segment_sum


class ConditionalGlobalAttention(nn.Module):
    def __init__(self, node_dim: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        D = out_features
        self.gate_nn = MLP2(D, D, 1, dtype)
        self.node_nn = MLP2(node_dim, D, D, dtype)
        self.ques_nn = MLP2(D, D, D, dtype)

    def forward(self, graph: GraphBatch, x, u):
        """x [N, node_dim], u [B, D] -> (readout [B, D], gate [N, 1])."""
        x = self.node_nn(x)
        uq = self.ques_nn(u)
        if graph.has_dense_layout:
            gate = self.gate_nn(broadcast_to_nodes(graph, uq) * x)
            gate = dense_node_softmax(graph, gate)
            return dense_segment_sum_nodes(graph, gate * x), gate
        B = graph.num_graphs
        uq_pad = torch.cat([uq, uq.new_zeros(1, uq.shape[-1])])
        gate = self.gate_nn(uq_pad.index_select(0, graph.node_graph) * x)
        gate = segment_softmax(gate, graph.node_graph, B + 1,
                               mask=graph.node_mask)
        out = segment_sum(gate * x, graph.node_graph, B + 1,
                          mask=graph.node_mask)
        return out[:B], gate
