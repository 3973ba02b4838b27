"""Language-conditioned global attention pooling, dense branch (port of
``graphvqa_tpu/nn/pooling.py``): gate = MLP(ques_nn(u) * node_nn(x)),
softmaxed over each graph's nodes, then the gate-weighted node sum."""
from __future__ import annotations

import torch
from torch import nn

from graphvqa_tpu_torch.core.graph import GraphBatch
from graphvqa_tpu_torch.nn.gnn import MLP2
from graphvqa_tpu_torch.ops.dense import (
    broadcast_to_nodes, dense_node_softmax, dense_segment_sum_nodes)


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
        gate = self.gate_nn(broadcast_to_nodes(graph, uq) * x)
        gate = dense_node_softmax(graph, gate)
        return dense_segment_sum_nodes(graph, gate * x), gate
