"""Random weights from the seed, made on the device in a few large draws:
the benchmark's input to the program and to the reference alike.

Each leaf gets the published initialisation's scale: N(0, 1) for the
embeddings and the decoder's query table; ones and zeros for the norms;
the engine's own leaves by its file's ``init_rule`` (``engines/<kind>.py``);
U(+-1/sqrt(fan_in)) for every other linear weight and bias, attention
in-projections included. All uniform leaves
come from one draw of U(-1, 1) and all normal ones from one draw of
N(0, 1), each cut into leaves and scaled; BatchNorm running statistics
start at 0 and 1.
"""
from __future__ import annotations

import math

import torch

import engines


def _rule(name: str, shape: tuple, shapes: dict, engine):
    """('normal' | 'uniform', bound) or ('fill', value) for one leaf."""
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 1)[0]
    if name.endswith("embedding.weight") or name.endswith("query_embed.weight"):
        return "normal", 1.0
    if "norm" in owner or ".bns." in name:
        return "fill", 1.0 if leaf == "weight" else 0.0
    own = engine.init_rule(name, shape)
    if own is not None:
        return own
    if leaf == "in_proj_weight":
        return "uniform", 1.0 / math.sqrt(shape[1])
    if leaf == "in_proj_bias":
        return "uniform", 1.0 / math.sqrt(shape[0] // 3)
    if leaf == "weight":
        return "uniform", 1.0 / math.sqrt(shape[1])
    if leaf == "bias":
        return "uniform", 1.0 / math.sqrt(shapes[owner + ".weight"][1])
    raise ValueError(f"no initialisation rule for {name}")


def make_weights(shapes: dict, seed: int, device, engine_kind: str) -> dict:
    """name -> float32 tensor on ``device`` for every leaf in ``shapes``
    (name -> shape) of a model whose engine is ``engine_kind``, from
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    engine = engines.load(engine_kind)
    rules = {n: _rule(n, s, shapes, engine) for n, s in shapes.items()}
    size = {k: sum(math.prod(shapes[n]) for n, r in rules.items()
                   if r[0] == k) for k in ("uniform", "normal")}
    pools = {
        "uniform": torch.empty(size["uniform"], device=device).uniform_(
            -1.0, 1.0, generator=gen),
        "normal": torch.empty(size["normal"], device=device).normal_(
            0.0, 1.0, generator=gen)}
    offset = {"uniform": 0, "normal": 0}
    out = {}
    for n, (kind, value) in rules.items():
        shape = tuple(shapes[n])
        if kind == "fill":
            out[n] = torch.full(shape, value, device=device)
            continue
        k = math.prod(shape)
        out[n] = (pools[kind][offset[kind]:offset[kind] + k] * value
                  ).reshape(shape)
        offset[kind] += k
    return out


def batch_norm_stats(shapes: dict, device) -> dict:
    """Initial running statistics of each BatchNorm named by its weight."""
    out = {}
    for n in shapes:
        if ".bns." in n and n.endswith(".weight"):
            base = n[:-len(".weight")]
            out[base + ".running_mean"] = torch.zeros(shapes[n], device=device)
            out[base + ".running_var"] = torch.ones(shapes[n], device=device)
    return out
