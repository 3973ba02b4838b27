"""The GINE baseline's engine: language-conditioned GINE rounds.

Reference (PyG's ``GINEConv`` on ``Seq(Lin, ReLU, Lin)`` in
codexxxl/GraphVQA): per round ``i`` the node rows ``[h ; ins_i]`` and the
edge rows ``[edge ; ins_i]``, the instruction vector of round ``i`` being
the same for every node and edge of a question; each edge's message
``relu([h ; ins_i][src] + [edge ; ins_i])`` summed into its destination;
``h = MLP((1 + eps) [h ; ins_i] + sum)`` on the real nodes; BatchNorm
(batch statistics in training) + ReLU + dropout between rounds.
Initialisation: ``nn.Linear``'s default, U(+-1/sqrt(fan_in)) for the MLPs'
weights and biases. No hand-written kernels.

Departures from the published equations, as the program (and the JAX
re-implementation it follows) has them:
  * ``eps`` is 0 and not trained (``train_eps=False``, the reference's
    default), so the update reads ``MLP([h ; ins_i] + sum)``;
  * the edge rows are the scene-graph encoder's 300-wide edge features
    widened by the instruction, so the message is 812 wide and no edge
    projection (PyG's ``lin`` for mismatched widths) exists;
  * padded edges and nodes of the dense layout give zeros; BatchNorm's
    statistics are over the real nodes only;
  * dropout draws come in the program's order: one per round but the last,
    on ``h`` after BatchNorm + ReLU.
"""
from __future__ import annotations

import math

import torch

from counts.flops import _lin
from reference.model import _gather, _scatter_sum


def forward(ref, x, e, memory, instr, b, gen, ctx_gen, train):
    eng = ref.cfg["engine"]
    B, npg, _ = x.shape
    epg = e.shape[1]
    rate, rounds = eng["dropout"], eng["num_rounds"]
    nmask = b["node_mask"][..., None].float()
    emask = b["edge_mask"][..., None].float()
    h = x
    for i in range(rounds):
        ins = instr[:, i, None]
        x_cat = torch.cat([h, ins.expand(B, npg, -1)], -1)
        e_cat = torch.cat([e, ins.expand(B, epg, -1)], -1)
        msg = ref.act(torch.relu(_gather(x_cat, b["src"]) + e_cat)) * emask
        aggr = ref.act(_scatter_sum(msg, b["dst"], npg))
        h = ref.mlp2(ref.act(x_cat + aggr), f"gine_seq.convs.{i}.nn") * nmask
        if i < rounds - 1:
            h = torch.relu(ref.batch_norm(h, f"gine_seq.bns.{i}", nmask,
                                          train))
            h = ref.drop(h, rate if gen is not None else 0.0, gen)
    return h


def flops(cfg, n, e, q):
    """Each round's MLP on the real nodes: [h ; ins] -> C -> C."""
    D, C = cfg["transformer"]["hidden_dim"], cfg["scene"]["emb_dim"]
    R = cfg["engine"]["num_rounds"]
    ops = R * (_lin(n, C + D, C) + _lin(n, C, C)).sum()
    return ops, C


def init_rule(name, shape):
    """``nn.Linear``'s default for ``.convs.N.nn.{0,2}.weight`` [out, in]:
    U(+-1/sqrt(in)). Its biases take the same bound from the weight beside
    them, which the shared rule for a bias gives (``None``)."""
    if ".convs." not in name or ".nn." not in name:
        return None
    if name.endswith(".weight"):
        return "uniform", 1.0 / math.sqrt(shape[1])
    return None
