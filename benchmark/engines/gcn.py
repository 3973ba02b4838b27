"""The GCN baseline's engine: language-conditioned GCN rounds.

Reference (PyG 1.x's ``GCNConv`` in codexxxl/GraphVQA,
``baseline_and_test_models/pipeline_model_gcn.py``): per round ``i`` the
node rows ``[h ; ins_i]``, the instruction vector of round ``i`` being the
same for every node of a question, projected ``xw = [h ; ins_i] W_i``; with
``dinv = rsqrt(indeg + 1)``, ``indeg`` counting each destination's real
in-edges and the + 1 being GCNConv's implicit self-loop,
``out[d] = sum over src -> d of dinv[src] dinv[d] xw[src]
+ dinv[d]^2 xw[d] + b_i``; BatchNorm (batch statistics in training) + ReLU
+ dropout between rounds. Initialisation: glorot-uniform for each round's
``weight`` [in, out], its ``bias`` 0. No hand-written kernels.

Departures from the released code, as the program (and the JAX
re-implementation it follows) has them:
  * ``h = conv_res``: the released code computes each round's ``conv_res``
    and never assigns it (``pipeline_model_gcn.py:660-666``), so its convs
    never reach ``h``; the program's ``fix_discarded_conv=True`` gives the
    intended semantics, and this file follows it;
  * the implicit self-loop is added on top of the dataset's ``<self>``
    edges, which count in ``indeg`` like any other edge;
  * padded nodes give zeros and padded edges nothing; BatchNorm's
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
    rate, rounds = eng["dropout"], eng["num_rounds"]
    nmask = b["node_mask"][..., None].float()
    emask = b["edge_mask"][..., None].float()
    dinv = torch.rsqrt(_scatter_sum(emask, b["dst"], npg) + 1.0)
    w = ref.act(_gather(dinv, b["src"]) * _gather(dinv, b["dst"]) * emask)
    h = x
    for i in range(rounds):
        cv = f"gcn_seq.convs.{i}"
        x_cat = torch.cat([h, instr[:, i, None].expand(B, npg, -1)], -1)
        xw = ref.mm(x_cat, ref.P[cv + ".weight"])
        aggr = ref.act(_scatter_sum(w * _gather(xw, b["src"]), b["dst"],
                                    npg))
        h = (aggr + xw * dinv * dinv + ref.P[cv + ".bias"]) * nmask
        if i < rounds - 1:
            h = torch.relu(ref.batch_norm(h, f"gcn_seq.bns.{i}", nmask,
                                          train))
            h = ref.drop(h, rate if gen is not None else 0.0, gen)
    return h


def flops(cfg, n, e, q):
    """Each round's projection of [h ; ins] on the real nodes and its
    weighted sum over the real edges."""
    D, C = cfg["transformer"]["hidden_dim"], cfg["scene"]["emb_dim"]
    R = cfg["engine"]["num_rounds"]
    ops = R * (_lin(n, C + D, C) + 2.0 * e * C).sum()
    return ops, C


def init_rule(name, shape):
    """PyG 1.x ``GCNConv``: glorot for ``.convs.N.weight`` [in, out], whose
    fans the shared rule (``[out, in]``) would read the wrong way round, and
    0 for ``.convs.N.bias``."""
    if ".convs." not in name:
        return None
    if name.endswith(".weight"):
        fan_in, fan_out = shape
        return "uniform", math.sqrt(6.0 / (fan_in + fan_out))
    if name.endswith(".bias"):
        return "fill", 0.0
    return None
