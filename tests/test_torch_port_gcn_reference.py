"""The port's GCN engine against the benchmark's plain reference of it
(``benchmark/engines/gcn.py``), on the CPU at a tiny width in float32:
the forward with dropout and BatchNorm's batch statistics, drawn from one
generator on both sides, and every gradient (parameters and inputs) at
rtol/atol 1e-5; the reference's initialisation of the rounds, PyG 1.x
``GCNConv``'s glorot weight [in, out] and zero bias; and the rounds'
device segments under the program's tracing.

The reference imports nothing of the port; this file is where the two
meet, so the benchmark's ``correct`` for a GCN cell rests on a model this
test holds to the port."""
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from graphvqa_tpu_torch.core import profiling
from graphvqa_tpu_torch.core.packing import GraphSample, pack_graphs_dense
from graphvqa_tpu_torch.nn.gnn import GCNSeq

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
sys.path.append(str(BENCH))

from engines import gcn  # noqa: E402
from harness import weights  # noqa: E402
from reference.model import Reference  # noqa: E402

C, D, R, RATE = 6, 5, 3, 0.25
NPG, EPG = 8, 12
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def grad_mode_on():
    """Every case differentiates: grad mode is set here, whatever a test
    run earlier in the same process left it at."""
    with torch.enable_grad():
        yield


def case(seed):
    """A GCNSeq with random weights, biases and BatchNorm affines, a packed
    batch of 3 ragged graphs (one with parallel edges and self-loops) and
    an empty one, its node features and instruction vectors."""
    torch.manual_seed(seed)
    seq = GCNSeq(C, D, num_rounds=R, dropout=RATE)
    with torch.no_grad():
        for conv in seq.convs:
            conv.weight.normal_(0.0, 0.4)
            conv.bias.normal_(0.0, 0.2)
        for bn in seq.bns:
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0.0, 0.2)
    rng = np.random.default_rng(seed)
    samples = []
    # the second graph fills its node rows, so its padded edges point at a
    # real node (the last): the masks, not the packing, keep them out
    for n, e in ((5, 9), (8, 7), (2, 3)):
        samples.append(GraphSample(
            np.ones((n, 12), np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            np.ones((e, 1), np.int32), np.zeros(e, bool)))
    g = pack_graphs_dense(samples, NPG, EPG, max_steps=R, num_graphs=4)
    x = torch.randn(g.nodes_pad, C) * g.node_mask[:, None]
    ins = torch.randn(R, 4, D)
    return seq, g, x, ins


def reference_batch(g) -> dict:
    """The reference's padded dense layout of a packed batch: graph-local
    indices [B, epg], masks [B, npg] and [B, epg]."""
    B = g.num_graphs
    return dict(src=(g.edge_src.long() % NPG).reshape(B, EPG),
                dst=(g.edge_dst.long() % NPG).reshape(B, EPG),
                node_mask=g.node_mask.reshape(B, NPG),
                edge_mask=g.edge_mask.reshape(B, EPG))


def reference_of(seq) -> Reference:
    params = {f"gcn_seq.{n}": p.detach().clone().requires_grad_(True)
              for n, p in seq.named_parameters()}
    cfg = {"transformer": {"hidden_dim": D, "num_heads": 1, "dropout": 0.0},
           "engine": {"kind": "gcn", "num_rounds": R, "dropout": RATE},
           "max_execution_steps": R, "classifier_dropout": 0.0}
    return Reference(params, cfg)


@pytest.mark.parametrize("seed", [0, 1])
def test_the_reference_follows_the_ports_gcn_rounds(seed):
    seq, g, x, ins = case(seed)
    B = g.num_graphs
    weight = torch.randn(g.nodes_pad, C)
    # the port, in training: dropout and batch statistics
    xs, ii = (t.clone().requires_grad_(True) for t in (x, ins))
    h = seq(g, xs, ii, generator=torch.Generator().manual_seed(seed),
            use_running_average=False)
    (h * weight).sum().backward()
    # the reference on the same weights, inputs and draws
    ref = reference_of(seq)
    xr = x.reshape(B, NPG, C).clone().requires_grad_(True)
    ir = ins.permute(1, 0, 2).clone().requires_grad_(True)
    hr = gcn.forward(ref, xr, None, None, ir, reference_batch(g),
                     torch.Generator().manual_seed(seed), None, True)
    (hr * weight.reshape(B, NPG, C)).sum().backward()

    torch.testing.assert_close(h.reshape(B, NPG, C), hr, **TOL)
    assert float(h.detach().abs().max()) > 0.1
    torch.testing.assert_close(xs.grad.reshape(B, NPG, C), xr.grad, **TOL)
    torch.testing.assert_close(ii.grad.permute(1, 0, 2), ir.grad, **TOL)
    for n, p in seq.named_parameters():
        torch.testing.assert_close(p.grad, ref.P[f"gcn_seq.{n}"].grad,
                                   **TOL, msg=n)
    # another draw moves the output: the draws reach the comparison
    other = seq(g, x, ins, generator=torch.Generator().manual_seed(seed + 7),
                use_running_average=False)
    assert float((other - h).detach().abs().max()) > 1e-2


def test_the_rounds_take_gcnconvs_glorot_and_zero_bias():
    """glorot for ``.convs.N.weight`` [in, out], 0 for ``.convs.N.bias``;
    the shared rules for everything else."""
    assert gcn.init_rule("gcn_seq.convs.2.weight", (812, 300)) == \
        ("uniform", math.sqrt(6 / 1112))
    assert gcn.init_rule("gcn_seq.convs.2.bias", (300,)) == ("fill", 0.0)
    for other in ("gcn_seq.bns.0.weight", "logit_fc.1.weight",
                  "graph_global_attention_pooling.node_nn.0.weight"):
        assert gcn.init_rule(other, (4, 4)) is None
    # drawn at the published widths: 812 in, 300 out
    shapes = {}
    for i in range(2):
        shapes.update({f"gcn_seq.convs.{i}.weight": (812, 300),
                       f"gcn_seq.convs.{i}.bias": (300,)})
    drawn = weights.make_weights(shapes, 11, torch.device("cpu"), "gcn")
    bound = math.sqrt(6 / (812 + 300))
    for n, t in drawn.items():
        if n.endswith(".bias"):
            assert float(t.abs().max()) == 0.0, n
            continue
        assert float(t.abs().max()) <= bound * (1 + 1e-6), n
        assert float(t.abs().max()) > 0.97 * bound, n
        # a uniform's standard deviation: bound / sqrt(3)
        assert abs(float(t.std()) * math.sqrt(3) / bound - 1) < 0.05, n


def test_each_round_stamps_its_projection_then_its_sum(monkeypatch):
    seq, g, x, ins = case(0)
    seen = []
    mark = profiling._mark
    monkeypatch.setattr(profiling, "_mark",
                        lambda k, dev: (seen.append(k), mark(k, dev)))
    seq(g, x, ins)
    assert seen == []
    profiling.reset_segments()
    profiling.enable(True)
    try:
        seq(g, x, ins)
        steps, seconds = profiling.read_segments()
    finally:
        profiling.enable(False)
        profiling.reset_segments()
    k = profiling.SEGMENTS.index
    assert seen == [k("engine"), k("engine_messages")] * R
    assert seconds["engine_messages"] > 0 and seconds["engine"] > 0
    assert steps == 0
