"""GraphVQA-GAT's engine: the language-conditioned GAT rounds.

Reference: a shared node projection gives the left and right scores and the
values, softmax over each destination's in-edges shifted by the graph's
largest logit per head (detached, and taken through ``exp(min(x, 0))``,
whose derivative at the maximum is 1/2), dropout on the normalized
attention, heads averaged plus a bias, a skip connection, BatchNorm + ReLU
+ dropout between rounds. Initialisation: glorot-uniform for the node and
edge projections and the attention vectors, the round's bias 0. Kernels:
the GAT round forward and backward, whose least bytes
``counts/gat_bytes.py`` counts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from counts.flops import _lin
from counts.gat_bytes import backward_bytes, forward_bytes
from reference.model import _gather, _scatter_sum


def forward(ref, x, e, memory, instr, b, gen, ctx_gen, train):
    eng = ref.cfg["engine"]
    B, npg, C = x.shape
    H = eng["heads"]
    rate, slope = eng["dropout"], eng["negative_slope"]
    rounds = eng["num_rounds"]
    nmask = b["node_mask"][..., None].float()
    h = x
    for i in range(rounds):
        cv = f"gat_seq.convs.{i}"
        ins = instr[:, i]
        xw = ref.lin(torch.cat([h, ins[:, None].expand(B, npg, -1)], -1),
                     cv + ".lin_l", bias=False).reshape(B, npg, H, C)
        ew = ref.lin(torch.cat([e, ins[:, None].expand(B, e.shape[1],
                                                       -1)], -1),
                     cv + ".lin_e", bias=False).reshape(B, -1, H, C)
        a_l = ref.act((xw * ref.P[cv + ".att_l"]).sum(-1))
        a_r = ref.act((xw * ref.P[cv + ".att_r"]).sum(-1))
        a_e = ref.act((ew * ref.P[cv + ".att_e"]).sum(-1))
        keep = None
        if gen is not None and rate > 0.0:
            keep = (torch.rand((B, e.shape[1], H), generator=gen,
                               device=x.device) >= rate
                    ).float() / (1.0 - rate)
        lg = F.leaky_relu(_gather(a_l, b["src"]) + _gather(a_r, b["dst"])
                          + a_e, slope)
        alpha = ref.act(ref.softmax_in_edges(lg, b, npg))
        if keep is not None:
            alpha = alpha * keep
        xs = ref.act(_gather(xw, b["src"]))
        out = _scatter_sum(alpha[..., None] * xs, b["dst"], npg)
        out = ref.act((out.mean(2) + ref.P[cv + ".bias"]) * nmask)
        h = out + h
        if i < rounds - 1:
            h = torch.relu(ref.batch_norm(h, f"gat_seq.bns.{i}", nmask,
                                          train))
            h = ref.drop(h, rate if gen is not None else 0.0, gen)
    return h


def flops(cfg, n, e, q):
    """Each round: the node projection with its two scores, the edge
    projection's score, the instruction's parts of both, the weighted sum
    over edges and the heads' mean."""
    eng = cfg["engine"]
    D, C = cfg["transformer"]["hidden_dim"], cfg["scene"]["emb_dim"]
    H, R = eng["heads"], eng["num_rounds"]
    ops = R * (_lin(n, C, H * C + 2 * H) + _lin(1, D, H * C + 2 * H)
               + _lin(e, C, H) + _lin(1, D, H)
               + 2.0 * e * H * C + 2.0 * n * H * C).sum()
    return ops, C


def init_rule(name, shape):
    if ".convs." not in name:
        return None
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 1)[0]
    if leaf in ("att_l", "att_r", "att_e"):
        _, h, c = shape
        return "uniform", math.sqrt(6.0 / (h + c))
    if leaf == "weight" and owner.rsplit(".", 1)[-1] in ("lin_l", "lin_e"):
        fan_out, fan_in = shape
        return "uniform", math.sqrt(6.0 / (fan_in + fan_out))
    if leaf == "bias":
        return "fill", 0.0
    return None


def kernel_bytes(cfg, counts, train):
    """Every round's forward launch, and in training its backward, on each
    traced batch."""
    eng = cfg["engine"]
    elem = 2 if cfg["dtype"] == "bfloat16" else 4
    fwd = bwd = 0
    for c in counts:
        args = (c["B"], c["npg"], c["epg"], eng["heads"],
                cfg["scene"]["emb_dim"], elem, c["n_src"], c["n_dst"],
                c["n_edges"])
        fwd += eng["num_rounds"] * forward_bytes(*args, with_keep=train)
        if train:
            bwd += eng["num_rounds"] * backward_bytes(*args)
    return fwd, bwd
