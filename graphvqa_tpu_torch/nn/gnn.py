"""Scene-graph MetaLayer and the message-passing engines (port of
``graphvqa_tpu/nn/gnn.py`` for the dense and the flat layout): the GAT
engine, and the baselines GCN, GINE and LCGN.

Parameters carry the reference names: ``edge_model.edge_mlp`` /
``node_model.node_mlp_{1,2}`` as ``Seq(Lin, ReLU, Lin)`` (indices 0 and 2),
and per GAT layer ``lin_l.weight`` [H*C, in+ins] (shared by the left and
right projections), ``lin_e.weight``, ``att_{l,r,e}`` [1, H, C] and ``bias``.
GCN: ``convs.i.weight`` in PyG 1.x's [in, out] layout and ``convs.i.bias``;
GINE: ``convs.i.nn.{0,2}`` and the ``convs.i.eps`` buffer (0); LCGN: the
reference's ``lcgn_seq`` names (``init_sg_emb_input.0``, ``qInput1``,
``qInput2_t``, ``cmd_inter2logits``, ``proj_x_{loc,ctx}.1``,
``output_layer``, ``fin_layer``, and the cell ``lcgn.{lin_l, lin_r, cal_x,
proj_cmd, cal_cmd}.weight`` with ``lcgn.bias``).

The JAX package's exact algebraic folds are kept, because they decide where
bf16 rounds:
  * ``w_aug`` carries the attention vectors: alpha_l/alpha_r come out of the
    node projection as 2H extra columns (``(x@W . att).sum(-1) == x @ (W.att)``);
  * the per-graph instruction vector never broadcasts to nodes: its score
    share enters at [B, H] and its value share at [B, H, C], aggregated
    through the attention row sums inside the GAT round;
  * the edge-score projection of every round is hoisted into one
    ``alpha_e_all`` product per step (``GATSeq``).
The baselines keep JAX's dtype flow too: GCN's projection rounds to the
compute dtype and ``xw * self_norm`` promotes to float32; LCGN's linear
layers default to float32 in the JAX package, so LCGN computes in float32
under the bf16 configuration as well.

Training (``forward`` with a ``generator``): dropout drawn here (GAT: as a
per-edge attention scale applied inside the GAT round), BatchNorm batch
statistics between rounds (``use_running_average=False``) and dropout on
``h`` after each BatchNorm + ReLU, as the JAX package's engines do.

The flat layout (a batch beyond the dense ladder) takes the JAX package's
flat round, plain ops under autograd: the instruction share added to every
node's projection (no ``ins_value`` share through the row sums), scores
from the projected rows, the segment softmax over destinations, dropout on
the attention, the message scatter and the head mean. The MetaLayer's
gathers and mean are index ops that serve both layouts as they are.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graphvqa_tpu_torch.core.graph import GraphBatch
from graphvqa_tpu_torch.nn.norm import MaskedBatchNorm
from graphvqa_tpu_torch.nn.transformer import (
    TorchLinear, dropout, matmul_f32)
from graphvqa_tpu_torch.ops import dense
from graphvqa_tpu_torch.ops.dispatch import aggregate_edge_values
from graphvqa_tpu_torch.ops.gat_round import gat_round, graph_logit_max
from graphvqa_tpu_torch.parallel.collectives import assemble_rows, pmax
from graphvqa_tpu_torch.ops.segment import (
    gather_nodes, scatter_edges_to_nodes, segment_softmax, segment_sum)


class MLP2(nn.Sequential):
    """Lin -> ReLU -> Lin (the reference's ``Seq(Lin, ReLU, Lin)``)."""

    def __init__(self, in_features: int, hidden: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(TorchLinear(in_features, hidden, dtype=dtype),
                         nn.ReLU(),
                         TorchLinear(hidden, features, dtype=dtype))


def graph_to_nodes(graph: GraphBatch, values: torch.Tensor) -> torch.Tensor:
    """Per-graph [B, D] -> per-node [N, D]: the dense broadcast (padded rows
    get their graph's value), or the flat gather (padded rows 0)."""
    if graph.has_dense_layout:
        return dense.broadcast_to_nodes(graph, values)
    pad = torch.cat([values, values.new_zeros(1, values.shape[-1])])
    return pad.index_select(0, graph.node_graph)


def graph_to_edges(graph: GraphBatch, values: torch.Tensor) -> torch.Tensor:
    """Per-graph [B, D] -> per-edge [E, D], as :func:`graph_to_nodes`."""
    if graph.has_dense_layout:
        return dense.broadcast_to_edges(graph, values)
    pad = torch.cat([values, values.new_zeros(1, values.shape[-1])])
    return pad.index_select(0, graph.edge_graph())


def gather_src(graph: GraphBatch, values: torch.Tensor) -> torch.Tensor:
    """``values[edge_src]``; the dense path zeroes padded edges."""
    if graph.has_dense_layout:
        return dense.dense_gather_src(graph, values)
    return gather_nodes(values, graph.edge_src)


def _bns(channels: int, num_rounds: int, dtype) -> nn.ModuleList:
    return nn.ModuleList(MaskedBatchNorm(channels, dtype=dtype)
                         for _ in range(num_rounds - 1))


def _between_rounds(seq, i, h, graph, generator, use_running_average):
    """BatchNorm + ReLU + dropout after every round but the last."""
    if i == seq.num_rounds - 1:
        return h
    h = torch.relu(seq.bns[i](h, mask=graph.node_mask,
                              use_running_average=use_running_average))
    rate = seq.dropout if generator is not None else 0.0
    return dropout(h, rate, generator)


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
        alpha_l, alpha_r = alpha_l.contiguous(), alpha_r.contiguous()
        alpha_e = alpha_e.reshape(B, epg, H)
        shift_max = None
        if graph.edge_group is not None and dense.SOFTMAX_SHIFT == "graph":
            # the whole graph's max, so that the shift and JAX's halved
            # derivative at the maximum are the single-device ones
            shift_max = pmax(graph_logit_max(
                dl, sl, mask, alpha_l, alpha_r, alpha_e, npg=npg,
                negative_slope=self.negative_slope), graph.edge_group)

        out = gat_round(
            dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
            ins_value.to(dt).contiguous(), npg=npg, epg=epg,
            negative_slope=self.negative_slope, shift=dense.SOFTMAX_SHIFT,
            keep_scale=keep_scale, return_alpha=return_alpha,
            shift_max=shift_max)
        if return_alpha:
            out, alpha = out
        # an edge-sharded round gives its owned destinations' rows only
        out = assemble_rows(out, graph.edge_group)
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
        self.bns = _bns(channels, num_rounds, dtype)

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
            h = _between_rounds(self, i, out + h, graph, generator,
                                use_running_average)
        return (h, torch.stack(alphas)) if return_alpha else h


class GCNConv(nn.Module):
    """One GCN convolution's parameters, PyG 1.x layout: ``weight`` [in,
    out] (glorot) and ``bias`` [out] (zeros)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))


class GCNSeq(nn.Module):
    """Instruction-conditioned GCN rounds (JAX ``GCNSeq``): per round
    ``xw = W [h ; ins]``, the symmetric-degree-normalized sum over in-edges
    plus one implicit self-loop per node (GCNConv adds its own on top of the
    dataset's ``<self>`` edges), and the bias. ``fix_discarded_conv=False``
    reproduces the released reference, whose convs never reach ``h``."""

    def __init__(self, channels: int, ins_dim: int, num_rounds: int = 5,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 fix_discarded_conv: bool = True):
        super().__init__()
        self.num_rounds, self.compute_dtype = num_rounds, dtype
        self.dropout, self.fix_discarded_conv = dropout, fix_discarded_conv
        self.convs = nn.ModuleList(GCNConv(channels + ins_dim, channels)
                                   for _ in range(num_rounds))
        self.bns = _bns(channels, num_rounds, dtype)

    def forward(self, graph: GraphBatch, x, instr_vectors, generator=None,
                use_running_average=True):
        """x [N, C], instr_vectors [R, B, ins_dim] -> h [N, C]."""
        dt, N = self.compute_dtype, graph.nodes_pad
        src, dst = graph.edge_src, graph.edge_dst
        ones = graph.edge_mask.float()
        if graph.has_dense_layout:
            deg = dense.dense_aggregate_edges(graph, ones[:, None])[:, 0]
        else:
            deg = segment_sum(ones, dst, N)
        dinv = torch.rsqrt(deg + 1.0)
        edge_norm = dinv.index_select(0, src) * dinv.index_select(0, dst)
        self_norm = dinv * dinv
        h = x
        for i, conv in enumerate(self.convs):
            x_cat = torch.cat([h, graph_to_nodes(graph, instr_vectors[i])], dim=-1)
            xw = matmul_f32(x_cat, conv.weight, dt).to(dt)
            if graph.has_dense_layout:
                w_edge = torch.where(graph.edge_mask, edge_norm, 0.0)[:, None]
                aggr = dense.dense_scatter_matmul(graph, w_edge,
                                                  xw[:, None, :])[:, 0, :]
            else:
                msgs = gather_nodes(xw, src) * edge_norm[:, None]
                aggr = aggregate_edge_values(graph, msgs)
            conv_res = aggr + xw * self_norm[:, None] + conv.bias
            conv_res = torch.where(graph.node_mask[:, None], conv_res, 0.0)
            if self.fix_discarded_conv:
                h = conv_res
            h = _between_rounds(self, i, h, graph, generator,
                                use_running_average)
        return h


class GINEConv(nn.Module):
    """One GINE convolution: ``nn`` = Seq(Lin, ReLU, Lin) and the ``eps``
    buffer, which must be 0 (the reference's train_eps=False default; a
    state dict with another value is refused when it loads)."""

    def __init__(self, in_features: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nn = MLP2(in_features, channels, channels, dtype)
        self.register_buffer("eps", torch.zeros(1))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        eps = state_dict.get(prefix + "eps")
        if eps is not None and bool((eps != 0).any()):
            raise ValueError(
                f"{prefix}eps is nonzero ({eps.tolist()}); GINESeq implements "
                f"the reference default train_eps=False/eps=0 only")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class GINESeq(nn.Module):
    """Instruction-conditioned GINE rounds (JAX ``GINESeq``): messages
    ``relu([h ; ins][src] + [edge ; ins])`` summed per destination, update
    ``MLP([h ; ins] + aggr)`` (eps = 0)."""

    def __init__(self, channels: int, ins_dim: int, num_rounds: int = 5,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.num_rounds, self.compute_dtype = num_rounds, dtype
        self.dropout = dropout
        self.convs = nn.ModuleList(GINEConv(channels + ins_dim, channels, dtype)
                                   for _ in range(num_rounds))
        self.bns = _bns(channels, num_rounds, dtype)

    def forward(self, graph: GraphBatch, x, edge_attr, instr_vectors,
                generator=None, use_running_average=True):
        """x [N, C], edge_attr [E, C], instr_vectors [R, B, ins_dim] -> h."""
        h = x
        for i, conv in enumerate(self.convs):
            ins = instr_vectors[i]
            x_cat = torch.cat([h, graph_to_nodes(graph, ins)], dim=-1)
            edge_cat = torch.cat([edge_attr, graph_to_edges(graph, ins)], dim=-1)
            msgs = torch.relu(gather_src(graph, x_cat) + edge_cat)
            h = conv.nn(x_cat + aggregate_edge_values(graph, msgs))
            h = torch.where(graph.node_mask[:, None], h, 0.0)
            h = _between_rounds(self, i, h, graph, generator,
                                use_running_average)
        return h


def _f32_linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """JAX ``GlorotLinear`` at its float32 default: ``x @ W^T`` in f32."""
    return matmul_f32(x, lin.weight.t(), torch.float32)


class LCGNCell(nn.Module):
    """The LCGN message-passing cell (JAX ``LCGNCell``): logit per edge
    ``<W_l x_src, proj_cmd * W_r x_dst>`` per head, LeakyReLU, destination
    softmax, message ``alpha * (cal_x x * cal_cmd)[src]``, heads averaged
    plus a bias. Float32 throughout, whatever the model's compute dtype."""

    def __init__(self, in_features: int, cmd_dim: int, out_channels: int,
                 heads: int = 1, negative_slope: float = 0.2,
                 dropout: float = 0.0):
        super().__init__()
        H, C = heads, out_channels
        self.heads, self.out_channels = H, C
        self.negative_slope, self.dropout = negative_slope, dropout
        for name in ("lin_l", "lin_r", "cal_x"):
            setattr(self, name, nn.Linear(in_features, H * C, bias=False))
        for name in ("proj_cmd", "cal_cmd"):
            setattr(self, name, nn.Linear(cmd_dim, H * C, bias=False))
        self.bias = nn.Parameter(torch.zeros(C))

    def glorot_linears(self):
        return (self.lin_l, self.lin_r, self.cal_x, self.proj_cmd,
                self.cal_cmd)

    def forward(self, graph: GraphBatch, x_joint, cmd, generator=None):
        """x_joint [N, in_features], cmd [B, cmd_dim] -> [N, C] float32."""
        H, C, N = self.heads, self.out_channels, graph.nodes_pad
        src, dst = graph.edge_src, graph.edge_dst
        x_l = _f32_linear(x_joint, self.lin_l)
        x_r = _f32_linear(x_joint, self.lin_r).reshape(N, H, C)
        proj_cmd = graph_to_nodes(graph, _f32_linear(cmd, self.proj_cmd))
        cal_cmd = graph_to_nodes(graph, _f32_linear(cmd, self.cal_cmd))
        x_mul = (proj_cmd.reshape(N, H, C) * x_r).reshape(N, H * C)
        if graph.has_dense_layout:
            x_l_src = dense.dense_gather_src(graph, x_l)
            x_mul_dst = dense.dense_gather_dst(graph, x_mul)
        else:
            x_l_src, x_mul_dst = gather_nodes(x_l, src), gather_nodes(x_mul, dst)
        E = x_l_src.shape[0]
        logits = (x_l_src.reshape(E, H, C) * x_mul_dst.reshape(E, H, C)
                  ).sum(-1)
        logits = torch.nn.functional.leaky_relu(logits, self.negative_slope)
        if graph.has_dense_layout:
            alpha = dense.dense_segment_softmax(graph, logits)
        else:
            alpha = segment_softmax(logits, dst, N, mask=graph.edge_mask)
        rate = self.dropout if generator is not None else 0.0
        alpha = dropout(alpha, rate, generator)
        x_val = _f32_linear(x_joint, self.cal_x).reshape(N, H, C)
        cal_cmd = cal_cmd.reshape(N, H, C)
        if graph.has_dense_layout:
            out = dense.dense_scatter_matmul(graph, alpha, x_val * cal_cmd)
        else:
            msgs = (gather_nodes(x_val, src) * gather_nodes(cal_cmd, src)
                    ) * alpha[..., None]
            out = aggregate_edge_values(graph, msgs.reshape(E, H * C))
        out = out.reshape(N, H, C).mean(dim=1) + self.bias
        return torch.where(graph.node_mask[:, None], out, 0.0)


class LCGNSeq(nn.Module):
    """The LCGN executor (JAX ``LCGNSeq``): per iteration a textual command
    from the question memory, then one :class:`LCGNCell` round updating the
    context features ``x_ctx``; float32 throughout.

    ``x_ctx`` starts as a fresh standard-normal draw at every forward, in
    training and in evaluation, as the reference's ``torch.randn`` does. It
    comes from ``ctx_generator``, an explicit ``torch.Generator`` on the
    nodes' device (never torch's global RNG); ``x_ctx`` given replaces the
    draw. The reference's ``bns`` are dead weights that its forward never
    reads: a reference state dict's ``bns.*`` entries are dropped when it
    loads."""

    def __init__(self, in_channels: int, q_dim: int, out_channels: int,
                 max_iters: int = 4, heads: int = 1,
                 negative_slope: float = 0.2, dropout: float = 0.0):
        super().__init__()
        C = out_channels
        self.max_iters, self.dropout = max_iters, dropout
        self.init_sg_emb_input = nn.Sequential(TorchLinear(in_channels, C))
        self.qInput1 = TorchLinear(q_dim, C)
        for t in range(max_iters):
            setattr(self, f"qInput2_{t}", TorchLinear(C, C))
        self.cmd_inter2logits = TorchLinear(C, 1)
        # Sequential(Dropout, Linear), reference layout; forward runs [1]
        # with explicit dropout draws
        self.proj_x_loc = nn.Sequential(nn.Dropout(dropout),
                                        TorchLinear(C, C))
        self.proj_x_ctx = nn.Sequential(nn.Dropout(dropout),
                                        TorchLinear(C, C))
        self.lcgn = LCGNCell(3 * C, q_dim, C, heads, negative_slope, dropout)
        self.output_layer = TorchLinear(2 * C, C)
        self.fin_layer = TorchLinear(2 * C, C)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for key in [k for k in state_dict if k.startswith(prefix + "bns.")]:
            del state_dict[key]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, graph: GraphBatch, x, q_encoding, lstm_outputs,
                generator=None, ctx_generator: Optional[torch.Generator] = None,
                x_ctx: Optional[torch.Tensor] = None):
        """x [N, in_channels], q_encoding [B, q_dim] (the first token's
        encoding), lstm_outputs [B, L, q_dim] (the question memory) ->
        [N, C] float32. ``generator`` draws dropout (None: none)."""
        rate = self.dropout if generator is not None else 0.0
        x_loc = dropout(self.init_sg_emb_input[0](x), rate, generator)
        if x_ctx is None:
            if ctx_generator is None:
                raise ValueError("LCGN draws x_ctx at every forward: pass "
                                 "ctx_generator (a torch.Generator) or x_ctx")
            x_ctx = torch.randn(x_loc.shape, generator=ctx_generator,
                                dtype=x_loc.dtype, device=x_loc.device)
        q_emb = torch.relu(self.qInput1(q_encoding))
        proj_x_loc = self.proj_x_loc[1](dropout(x_loc, rate, generator))
        memory = lstm_outputs.float()
        for t in range(self.max_iters):
            q_cmd = getattr(self, f"qInput2_{t}")(q_emb)           # [B, C]
            raw_att = self.cmd_inter2logits(q_cmd[:, None, :] * memory)
            att = torch.softmax(raw_att[..., 0], dim=-1)           # [B, L]
            cmd = torch.einsum("bl,bld->bd", att, memory)
            proj_x_ctx = self.proj_x_ctx[1](dropout(x_ctx, rate, generator))
            x_joint = torch.cat([x_loc, x_ctx, proj_x_ctx * proj_x_loc],
                                dim=-1)
            msg_aggr = self.lcgn(graph, x_joint, cmd, generator)
            x_ctx = self.output_layer(torch.cat([x_ctx, msg_aggr], dim=-1))
        out = self.fin_layer(torch.cat([x_loc, x_ctx], dim=-1))
        return torch.where(graph.node_mask[:, None], out, 0.0)
