"""The LCGN baseline's engine: language-conditioned graph networks.

Reference: ``lcgn_iters`` iterations of textual command, context-feature
update and message passing, in float32, with context features drawn from a
standard normal at every forward (from ``ctx_gen``). Initialisation:
glorot-uniform for the cell's projections (``.lcgn.``), its bias 0. No
hand-written kernels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from counts.flops import _lin
from reference.model import _gather, _scatter_sum


def forward(ref, x, e, memory, instr, b, gen, ctx_gen, train):
    eng = ref.cfg["engine"]
    n = "lcgn_seq"
    npg = x.shape[1]
    nmask = b["node_mask"][..., None].float()
    rate = eng["dropout"] if gen is not None else 0.0
    slope = eng["negative_slope"]
    x_loc = ref.drop(ref.lin(x, f"{n}.init_sg_emb_input.0"), rate, gen)
    x_ctx = torch.randn(x_loc.shape, generator=ctx_gen,
                        device=x_loc.device)
    q_emb = torch.relu(ref.lin(memory[:, 0], f"{n}.qInput1"))
    proj_loc = ref.lin(ref.drop(x_loc, rate, gen), f"{n}.proj_x_loc.1")
    for t in range(eng["lcgn_iters"]):
        q_cmd = ref.lin(q_emb, f"{n}.qInput2_{t}")
        raw = ref.lin(q_cmd[:, None] * memory, f"{n}.cmd_inter2logits")
        att = torch.softmax(raw[..., 0], -1)
        cmd = torch.einsum("bl,bld->bd", att, memory)
        proj_ctx = ref.lin(ref.drop(x_ctx, rate, gen),
                           f"{n}.proj_x_ctx.1")
        joint = torch.cat([x_loc, x_ctx, proj_ctx * proj_loc], -1)
        cell = f"{n}.lcgn"
        x_l = ref.lin(joint, cell + ".lin_l", bias=False)
        x_r = ref.lin(joint, cell + ".lin_r", bias=False)
        p_cmd = ref.lin(cmd, cell + ".proj_cmd", bias=False)[:, None]
        c_cmd = ref.lin(cmd, cell + ".cal_cmd", bias=False)[:, None]
        x_mul = p_cmd * x_r
        lg = (_gather(x_l, b["src"]) * _gather(x_mul, b["dst"])).sum(
            -1, keepdim=True)
        alpha = ref.softmax_in_edges(F.leaky_relu(lg, slope), b, npg)
        alpha = ref.drop(alpha, rate, gen)
        val = ref.lin(joint, cell + ".cal_x", bias=False) * c_cmd
        msg = _scatter_sum(alpha * _gather(val, b["src"]), b["dst"], npg)
        msg = (msg + ref.P[cell + ".bias"]) * nmask
        x_ctx = ref.lin(torch.cat([x_ctx, msg], -1), f"{n}.output_layer")
    return ref.lin(torch.cat([x_loc, x_ctx], -1), f"{n}.fin_layer") * nmask


def flops(cfg, n, e, q):
    """Each iteration: the command, the context projection, the cell's
    three node projections and two command projections, its edge products
    and the output layer; then the input, location and question
    projections and the final layer."""
    eng = cfg["engine"]
    D, C = cfg["transformer"]["hidden_dim"], cfg["scene"]["emb_dim"]
    H, I = eng["lcgn_heads"], eng["lcgn_iters"]
    it = (_lin(1, D, D) + _lin(q, D, 1) + 2.0 * q * D          # command
          + _lin(n, D, D)                                      # proj_x_ctx
          + 3 * _lin(n, 3 * D, H * D) + 2 * _lin(1, D, H * D)  # the cell
          + 2.0 * e * H * D + 2.0 * e * H * D                  # edges
          + _lin(n, 2 * D, D))                                 # output
    ops = (I * it + _lin(n, C, D) + _lin(n, D, D) + _lin(1, D, D)
           + _lin(n, 2 * D, D)).sum()
    return ops, D


def init_rule(name, shape):
    if ".lcgn." not in name:
        return None
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight":
        fan_out, fan_in = shape
        return "uniform", math.sqrt(6.0 / (fan_in + fan_out))
    if leaf == "bias":
        return "fill", 0.0
    return None
