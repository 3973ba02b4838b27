"""Scene-graph MetaLayer and the GAT engine (port of ``graphvqa_tpu/nn/gnn.py``
for the dense and the flat layout).

Parameters carry the reference names: ``edge_model.edge_mlp`` /
``node_model.node_mlp_{1,2}`` as ``Seq(Lin, ReLU, Lin)`` (indices 0 and 2),
and per GAT layer ``lin_l.weight`` [H*C, in+ins] (shared by the left and
right projections), ``lin_e.weight``, ``att_{l,r,e}`` [1, H, C] and ``bias``.

The JAX package's exact algebraic folds are kept, because they decide where
bf16 rounds:
  * ``w_aug`` carries the attention vectors: alpha_l/alpha_r come out of the
    node projection as 2H extra columns (``(x@W . att).sum(-1) == x @ (W.att)``);
  * the per-graph instruction vector never broadcasts to nodes: its score
    share enters at [B, H] and its value share at [B, H, C], aggregated
    through the attention row sums inside the GAT round;
  * the edge-score projection of every round is hoisted into one
    ``alpha_e_all`` product per step (``GATSeq``).

Training (``GATSeq.forward`` with a ``generator``): attention dropout as a
per-edge scale drawn here and applied inside the GAT round, BatchNorm batch
statistics between rounds (``use_running_average=False``) and dropout on
``h`` after each BatchNorm + ReLU, as the JAX package's ``GATSeq`` does.

The flat layout (a batch beyond the dense ladder) takes the JAX package's
flat round, plain ops under autograd: the instruction share added to every
node's projection (no ``ins_value`` share through the row sums), scores
from the projected rows, the segment softmax over destinations, dropout on
the attention, the message scatter and the head mean. The MetaLayer's
gathers and mean are index ops that serve both layouts as they are.
"""
from __future__ import annotations

import torch
from torch import nn

from graphvqa_tpu_torch.core.graph import GraphBatch
from graphvqa_tpu_torch.nn.norm import MaskedBatchNorm
from graphvqa_tpu_torch.nn.transformer import (
    TorchLinear, dropout, matmul_f32)
from graphvqa_tpu_torch.ops import dense
from graphvqa_tpu_torch.ops.gat_round import gat_round
from graphvqa_tpu_torch.ops.segment import (
    gather_nodes, scatter_edges_to_nodes, segment_softmax)


class MLP2(nn.Sequential):
    """Lin -> ReLU -> Lin (the reference's ``Seq(Lin, ReLU, Lin)``)."""

    def __init__(self, in_features: int, hidden: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(TorchLinear(in_features, hidden, dtype=dtype),
                         nn.ReLU(),
                         TorchLinear(hidden, features, dtype=dtype))


class SceneGraphMetaLayer(nn.Module):
    """One MetaLayer round: edge update from [src, dst, edge], then a node
    update from the mean of the transformed incident-edge messages."""

    def __init__(self, node_dim: int, edge_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.edge_model = nn.ModuleDict({"edge_mlp": MLP2(
            2 * node_dim + edge_dim, edge_dim, edge_dim, dtype)})
        self.node_model = nn.ModuleDict({
            "node_mlp_1": MLP2(node_dim + edge_dim, node_dim, node_dim, dtype),
            "node_mlp_2": MLP2(2 * node_dim, node_dim, node_dim, dtype)})

    def forward(self, graph: GraphBatch, x, edge_attr):
        x_src = dense.dense_gather_src(graph, x)
        x_dst = dense.dense_gather_dst(graph, x)
        edge_out = self.edge_model["edge_mlp"](
            torch.cat([x_src, x_dst, edge_attr], dim=-1))
        edge_out = torch.where(graph.edge_mask[:, None], edge_out, 0.0)
        node_msg = self.node_model["node_mlp_1"](
            torch.cat([x_src, edge_out], dim=-1))
        aggregated = dense.dense_aggregate_edges(graph, node_msg, reduce="mean")
        node_out = self.node_model["node_mlp_2"](
            torch.cat([x, aggregated], dim=-1))
        node_out = torch.where(graph.node_mask[:, None], node_out, 0.0)
        return node_out, edge_out


class GATLayer(nn.Module):
    """Edge-featured multi-head GAT layer, dense layout, heads averaged
    (concat=False) plus bias; the round itself is the fused kernel."""

    def __init__(self, in_channels: int, edge_channels: int, ins_dim: int,
                 out_channels: int, heads: int = 4,
                 negative_slope: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H, C = heads, out_channels
        self.heads, self.out_channels = H, C
        self.in_channels, self.edge_channels = in_channels, edge_channels
        self.negative_slope, self.compute_dtype = negative_slope, dtype
        self.lin_l = nn.Linear(in_channels + ins_dim, H * C, bias=False)
        self.lin_e = nn.Linear(edge_channels + ins_dim, H * C, bias=False)
        self.att_l = nn.Parameter(torch.empty(1, H, C))
        self.att_r = nn.Parameter(torch.empty(1, H, C))
        self.att_e = nn.Parameter(torch.empty(1, H, C))
        self.bias = nn.Parameter(torch.zeros(C))

    def edge_att(self) -> torch.Tensor:
        """Collapsed edge-score matrix ``(We . att_e).sum(-1)`` [e_c+ins, H]."""
        H, C = self.heads, self.out_channels
        return (self.lin_e.weight.t().reshape(-1, H, C) * self.att_e).sum(-1)

    def forward(self, graph: GraphBatch, x, ins, alpha_e_base, dl, sl, mask,
                keep_scale=None, return_alpha=False):
        """x [N, in_c]; ins [B, ins_dim]; alpha_e_base [E, H] (this round's
        slice of GATSeq's hoisted edge scores); dl / sl / mask [B, epg] the
        graph's local edge indices and edge mask (the same every round);
        keep_scale [B, epg, H] the attention dropout scale or None
        -> [N, C] float32, and with ``return_alpha`` the attention [E, H].
        The softmax shift is ``GRAPHVQA_SOFTMAX_SHIFT`` (ops/dense.py)."""
        B, npg, epg = dense.dense_shapes(graph)
        H, C, dt = self.heads, self.out_channels, self.compute_dtype
        N, x_dim = graph.nodes_pad, self.in_channels
        w = self.lin_l.weight.t()                                # [in+ins, H*C]
        w3 = w.reshape(-1, H, C)
        wa_l = (w3 * self.att_l).sum(-1)                         # [in+ins, H]
        wa_r = (w3 * self.att_r).sum(-1)
        w_aug = torch.cat([w[:x_dim], wa_l[:x_dim], wa_r[:x_dim]], dim=1)
        proj = matmul_f32(x, w_aug, dt)                          # [N, H*C+2H]
        # a copy in every dtype: in float32 .to(dt) would keep the strided
        # view into proj, and the kernel takes contiguous tensors only
        xw = proj[:, :H * C].reshape(N, H, C).to(dt).contiguous()
        alpha_l = proj[:, H * C:H * C + H]
        alpha_r = proj[:, H * C + H:]
        ins_value = matmul_f32(ins, w[x_dim:], dt).reshape(B, H, C)
        alpha_l = alpha_l + dense.broadcast_to_nodes(
            graph, (ins_value * self.att_l).sum(-1))
        alpha_r = alpha_r + dense.broadcast_to_nodes(
            graph, (ins_value * self.att_r).sum(-1))
        ins_e = matmul_f32(ins, self.edge_att()[self.edge_channels:], dt)
        alpha_e = (alpha_e_base + dense.broadcast_to_edges(graph, ins_e)).to(dt)

        out = gat_round(
            dl, sl, mask, alpha_l.contiguous(), alpha_r.contiguous(),
            alpha_e.reshape(B, epg, H), xw, ins_value.to(dt).contiguous(),
            npg=npg, epg=epg, negative_slope=self.negative_slope,
            shift=dense.SOFTMAX_SHIFT, keep_scale=keep_scale,
            return_alpha=return_alpha)
        if return_alpha:
            out, alpha = out
        out = torch.where(graph.node_mask[:, None], out + self.bias, 0.0)
        return (out, alpha) if return_alpha else out

    def forward_flat(self, graph: GraphBatch, x, ins, alpha_e_base,
                     rate=0.0, generator=None, return_alpha=False):
        """The round on the flat layout: x [N, in_c], ins [B, ins_dim],
        alpha_e_base [E, H] -> [N, C] float32 (and the attention [E, H]),
        with dropout of ``rate`` on the attention drawn from ``generator``."""
        H, C, dt = self.heads, self.out_channels, self.compute_dtype
        N, x_dim = graph.nodes_pad, self.in_channels
        src, dst = graph.edge_src, graph.edge_dst
        w = self.lin_l.weight.t()                                # [in+ins, H*C]
        ins_w = matmul_f32(ins, w[x_dim:], dt)                   # [B, H*C]
        ins_w = torch.cat([ins_w, ins_w.new_zeros(1, H * C)])
        xw = matmul_f32(x, w[:x_dim], dt) + ins_w.index_select(
            0, graph.node_graph)
        xw = xw.reshape(N, H, C).to(dt)
        alpha_l = (xw * self.att_l).sum(-1)                      # [N, H]
        alpha_r = (xw * self.att_r).sum(-1)
        ins_e = matmul_f32(ins, self.edge_att()[self.edge_channels:], dt)
        ins_e = torch.cat([ins_e, ins_e.new_zeros(1, H)])
        alpha_e = (alpha_e_base + ins_e.index_select(0, graph.edge_graph())
                   ).to(dt)
        logits = (gather_nodes(alpha_l, src) + gather_nodes(alpha_r, dst)
                  + alpha_e)
        logits = torch.nn.functional.leaky_relu(logits, self.negative_slope)
        alpha = segment_softmax(logits, dst, N, mask=graph.edge_mask)
        alpha = dropout(alpha, rate, generator)
        msgs = gather_nodes(xw, src) * alpha[..., None]
        out = scatter_edges_to_nodes(msgs, dst, N, edge_mask=graph.edge_mask)
        out = out.mean(dim=1) + self.bias
        out = torch.where(graph.node_mask[:, None], out, 0.0)
        return (out, alpha) if return_alpha else out


class GATSeq(nn.Module):
    """Instruction-conditioned GAT rounds with skip connections and
    BatchNorm + ReLU between rounds."""

    def __init__(self, channels: int, ins_dim: int, num_rounds: int = 5,
                 heads: int = 4, negative_slope: float = 0.2,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.heads, self.num_rounds, self.compute_dtype = (
            heads, num_rounds, dtype)
        self.dropout = dropout
        self.convs = nn.ModuleList(
            GATLayer(channels, channels, ins_dim, channels, heads,
                     negative_slope, dtype) for _ in range(num_rounds))
        self.bns = nn.ModuleList(
            MaskedBatchNorm(channels, dtype=dtype)
            for _ in range(num_rounds - 1))

    def forward(self, graph: GraphBatch, x, edge_attr, instr_vectors,
                generator=None, use_running_average=True, return_alpha=False):
        """x [N, C], edge_attr [E, C], instr_vectors [R, B, ins_dim] -> h
        [N, C], and with ``return_alpha`` the attention of every round
        [R, E, H]. ``generator`` (None: deterministic) draws the dropout."""
        H, e_c = self.heads, edge_attr.shape[-1]
        # the static edge scores of every round in one [E, e_c] x [e_c, R*H]
        we_att_all = torch.cat([conv.edge_att()[:e_c] for conv in self.convs],
                               dim=-1)
        alpha_e_all = matmul_f32(edge_attr, we_att_all, self.compute_dtype)
        flat = not graph.has_dense_layout
        if not flat:
            B, _, epg = dense.dense_shapes(graph)
            dl, sl = dense.dense_local_indices(graph)
            mask = graph.edge_mask.reshape(B, epg).float()
        h, alphas = x, []
        rate = self.dropout if generator is not None else 0.0
        for i, conv in enumerate(self.convs):
            alpha_e = alpha_e_all[:, i * H:(i + 1) * H]
            if flat:
                out = conv.forward_flat(graph, h, instr_vectors[i], alpha_e,
                                        rate, generator, return_alpha)
            else:
                keep = None
                if rate > 0.0:
                    keep = (torch.rand((B, epg, H), generator=generator,
                                       device=mask.device) >= rate).float() \
                        / (1.0 - rate)
                out = conv(graph, h, instr_vectors[i], alpha_e, dl, sl, mask,
                           keep_scale=keep, return_alpha=return_alpha)
            if return_alpha:
                out, alpha = out
                alphas.append(alpha)
            h = out + h
            if i != self.num_rounds - 1:
                h = torch.relu(self.bns[i](
                    h, mask=graph.node_mask,
                    use_running_average=use_running_average))
                h = dropout(h, rate, generator)
        return (h, torch.stack(alphas)) if return_alpha else h
