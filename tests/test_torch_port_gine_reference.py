"""The port's GINE engine against the benchmark's plain reference of it
(``benchmark/engines/gine.py``), on the CPU at a tiny width in float32:
the forward with dropout and BatchNorm's batch statistics, drawn from one
generator on both sides, and every gradient (parameters and inputs) at
rtol/atol 1e-5; and the reference's initialisation of the rounds' MLPs,
``nn.Linear``'s default U(+-1/sqrt(fan_in)). Also what the benchmark needs
of the port's GINE besides: a state dict of parameters alone loads (eps
stays 0), and the rounds' device segments under the program's tracing.

The reference imports nothing of the port; this file is where the two
meet, so the benchmark's ``correct`` for a GINE cell rests on a model this
test holds to the port."""
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from graphvqa_tpu_torch.core import profiling
from graphvqa_tpu_torch.core.packing import GraphSample, pack_graphs_dense
from graphvqa_tpu_torch.nn.gnn import GINEConv, GINESeq

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
sys.path.append(str(BENCH))

from engines import gine  # noqa: E402
from harness import weights  # noqa: E402
from reference.model import Reference  # noqa: E402

C, D, R, RATE = 6, 5, 3, 0.25
NPG, EPG = 8, 12
TOL = dict(rtol=1e-5, atol=1e-5)


def case(seed):
    """A GINESeq with random weights, a packed batch of 3 ragged graphs and
    an empty one, its node and edge features and instruction vectors."""
    torch.manual_seed(seed)
    seq = GINESeq(C, D, num_rounds=R, dropout=RATE)
    with torch.no_grad():
        for bn in seq.bns:
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0.0, 0.2)
    rng = np.random.default_rng(seed)
    samples = []
    # the second graph fills its node rows, so its padded edges point at a
    # real node (the last): the masks, not the packing, keep them out
    for n, e in ((5, 9), (8, 7), (2, 1)):
        samples.append(GraphSample(
            np.ones((n, 12), np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            np.ones((e, 1), np.int32), np.zeros(e, bool)))
    g = pack_graphs_dense(samples, NPG, EPG, max_steps=R, num_graphs=4)
    x = torch.randn(g.nodes_pad, C) * g.node_mask[:, None]
    e = torch.randn(g.edges_pad, C) * g.edge_mask[:, None]
    ins = torch.randn(R, 4, D)
    return seq, g, x, e, ins


def reference_batch(g) -> dict:
    """The reference's padded dense layout of a packed batch: graph-local
    indices [B, epg], masks [B, npg] and [B, epg]."""
    B = g.num_graphs
    return dict(src=(g.edge_src.long() % NPG).reshape(B, EPG),
                dst=(g.edge_dst.long() % NPG).reshape(B, EPG),
                node_mask=g.node_mask.reshape(B, NPG),
                edge_mask=g.edge_mask.reshape(B, EPG))


def reference_of(seq) -> Reference:
    params = {f"gine_seq.{n}": p.detach().clone().requires_grad_(True)
              for n, p in seq.named_parameters()}
    cfg = {"transformer": {"hidden_dim": D, "num_heads": 1, "dropout": 0.0},
           "engine": {"kind": "gine", "num_rounds": R, "dropout": RATE},
           "max_execution_steps": R, "classifier_dropout": 0.0}
    return Reference(params, cfg)


@pytest.mark.parametrize("seed", [0, 1])
def test_the_reference_follows_the_ports_gine_rounds(seed):
    seq, g, x, e, ins = case(seed)
    B = g.num_graphs
    weight = torch.randn(g.nodes_pad, C)
    # the port, in training: dropout and batch statistics
    xs, es, ii = (t.clone().requires_grad_(True) for t in (x, e, ins))
    h = seq(g, xs, es, ii, generator=torch.Generator().manual_seed(seed),
            use_running_average=False)
    (h * weight).sum().backward()
    # the reference on the same weights, inputs and draws
    ref = reference_of(seq)
    xr = x.reshape(B, NPG, C).clone().requires_grad_(True)
    er = e.reshape(B, EPG, C).clone().requires_grad_(True)
    ir = ins.permute(1, 0, 2).clone().requires_grad_(True)
    hr = gine.forward(ref, xr, er, None, ir, reference_batch(g),
                      torch.Generator().manual_seed(seed), None, True)
    (hr * weight.reshape(B, NPG, C)).sum().backward()

    torch.testing.assert_close(h.reshape(B, NPG, C), hr, **TOL)
    assert float(h.detach().abs().max()) > 0.1
    torch.testing.assert_close(xs.grad.reshape(B, NPG, C), xr.grad, **TOL)
    torch.testing.assert_close(es.grad.reshape(B, EPG, C), er.grad, **TOL)
    torch.testing.assert_close(ii.grad.permute(1, 0, 2), ir.grad, **TOL)
    for n, p in seq.named_parameters():
        torch.testing.assert_close(p.grad, ref.P[f"gine_seq.{n}"].grad,
                                   **TOL, msg=n)


def test_dropout_draws_reach_the_comparison():
    """Another draw moves the port's output: the test above compares the
    draws, not an engine where dropout never acts."""
    seq, g, x, e, ins = case(0)
    a = seq(g, x, e, ins, generator=torch.Generator().manual_seed(0),
            use_running_average=False)
    b = seq(g, x, e, ins, generator=torch.Generator().manual_seed(1),
            use_running_average=False)
    assert float((a - b).detach().abs().max()) > 1e-2


def test_the_mlps_take_nn_linears_default_initialisation():
    """U(+-1/sqrt(fan_in)) for each round's weights and biases: the engine's
    rule for the weights, the shared rule for the biases beside them."""
    fan = {"0": C + D, "2": C}
    for k, fan_in in fan.items():
        rule = gine.init_rule(f"gine_seq.convs.1.nn.{k}.weight", (C, fan_in))
        assert rule == ("uniform", 1 / math.sqrt(fan_in))
        assert gine.init_rule(f"gine_seq.convs.1.nn.{k}.bias", (C,)) is None
    for other in ("gine_seq.bns.0.weight", "logit_fc.1.weight",
                  "graph_global_attention_pooling.node_nn.0.weight"):
        assert gine.init_rule(other, (4, 4)) is None
    # drawn at the published widths: 300 channels, 812-wide input
    shapes = {}
    for i in range(2):
        shapes.update({f"gine_seq.convs.{i}.nn.0.weight": (300, 812),
                       f"gine_seq.convs.{i}.nn.0.bias": (300,),
                       f"gine_seq.convs.{i}.nn.2.weight": (300, 300),
                       f"gine_seq.convs.{i}.nn.2.bias": (300,)})
    drawn = weights.make_weights(shapes, 11, torch.device("cpu"), "gine")
    for n, t in drawn.items():
        bound = 1 / math.sqrt(812 if ".nn.0." in n else 300)
        assert float(t.abs().max()) <= bound * (1 + 1e-6), n
        assert float(t.abs().max()) > 0.97 * bound, n
        # a uniform's standard deviation: bound / sqrt(3)
        assert abs(float(t.std()) * math.sqrt(3) / bound - 1) < 0.15, n


def test_a_state_dict_without_eps_loads_strictly():
    """The benchmark's weights are the parameters alone: eps, a buffer
    that can only be 0, stays 0."""
    conv = GINEConv(C + D, C)
    params = {n: torch.randn_like(p) for n, p in conv.named_parameters()}
    conv.load_state_dict(params, strict=True)
    assert float(conv.eps.abs().max()) == 0.0
    torch.testing.assert_close(conv.nn[0].weight, params["nn.0.weight"])


def test_each_round_stamps_its_messages_while_tracing_is_on(monkeypatch):
    seq, g, x, e, ins = case(0)
    seen = []
    mark = profiling._mark
    monkeypatch.setattr(profiling, "_mark",
                        lambda k, dev: (seen.append(k), mark(k, dev)))
    seq(g, x, e, ins)
    assert seen == []
    profiling.reset_segments()
    profiling.enable(True)
    try:
        seq(g, x, e, ins)
        steps, seconds = profiling.read_segments()
    finally:
        profiling.enable(False)
        profiling.reset_segments()
    k = profiling.SEGMENTS.index
    assert seen == [k("engine"), k("engine_messages")] * R
    assert seconds["engine_messages"] > 0 and seconds["engine"] > 0
    assert steps == 0
