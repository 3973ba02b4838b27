"""The GINE round's messages and sum (``ops/gine_messages.py``) against
autograd through the composite it replaces (``nn/gnn.py:GINESeq``'s
concatenations, ``dense_gather_src``, ReLU and ``dense_aggregate_edges``),
on the CPU, where the wrapper runs the plain versions.

Tolerances. float32: rtol/atol 1e-5, the same float32 sums in another
order. bfloat16: the forward is bit for bit the composite's (its sums are
float32 either way, rounded once); the backward's float32 sums round once,
where the composite's bf16 ``index_add_`` and autograd's bf16 accumulation
round at each add, so dh and d_ins may differ by 2 bf16 ulps (2^-6) of the
tensor's largest value; d_edge_attr is the same bf16 values masked by the
same signs, so it is equal bit for bit in every dtype. The ins half of z
is bit for bit the composite's wherever its values are bf16 (design note 1
of the module).
"""
import dataclasses

import numpy as np
import pytest
import torch

from graphvqa_tpu_torch.core.packing import GraphSample, pack_graphs_dense
from graphvqa_tpu_torch.nn import gnn
from graphvqa_tpu_torch.nn.gnn import (
    GINESeq, gather_src, graph_to_edges, graph_to_nodes)
from graphvqa_tpu_torch.ops import dense
from graphvqa_tpu_torch.ops import gine_messages as gm
from graphvqa_tpu_torch.ops.cuda_lib import launch_counts
from graphvqa_tpu_torch.ops.dispatch import aggregate_edge_values

C, D = 12, 8
F32, BF16 = torch.float32, torch.bfloat16
# (h, edge_attr, ins) dtypes: float32, bf16, and the bf16 model's first
# round, whose h is the scene encoder's float32 output
DTYPES = {"float32": (F32, F32, F32), "bfloat16": (BF16, BF16, BF16),
          "mixed": (F32, BF16, BF16)}
# the tiny main rung and a bumped one
RUNGS = [(8, 32), (16, 64)]


def batch(npg, epg, seed, sizes=None, num_graphs=None):
    """Ragged graphs with parallel edges and self-loops: one that fills its
    rows (its padded edges point at a real node), one without edges and a
    fully padded graph at the end."""
    rng = np.random.default_rng(seed)
    sizes = sizes or ((npg, epg), (3, 0), (npg // 2, epg // 2), (2, 5))
    samples = [GraphSample(
        np.ones((n, 12), np.int32), rng.integers(0, n, e).astype(np.int32),
        rng.integers(0, n, e).astype(np.int32), np.ones((e, 1), np.int32),
        np.zeros(e, bool)) for n, e in sizes]
    return pack_graphs_dense(samples, npg, epg,
                             num_graphs=num_graphs or len(samples) + 1)


def inputs(g, dtypes, seed):
    gen = torch.Generator().manual_seed(seed)
    th, te, ti = dtypes
    return (torch.randn(g.nodes_pad, C, generator=gen).to(th),
            torch.randn(g.num_graphs, D, generator=gen).to(ti),
            torch.randn(g.edges_pad, C, generator=gen).to(te))


def indices(g):
    dl, sl = dense.dense_local_indices(g)
    return dl, sl, g.edge_mask.reshape(dl.shape)


def composite(g, h, ins, edge_attr):
    """The rounds' composite, as ``GINESeq`` runs it off the dense path."""
    x_cat = torch.cat([h, graph_to_nodes(g, ins)], dim=-1)
    edge_cat = torch.cat([edge_attr, graph_to_edges(g, ins)], dim=-1)
    msgs = torch.relu(gather_src(g, x_cat) + edge_cat)
    return x_cat + aggregate_edge_values(g, msgs)


def both(g, h, ins, edge_attr, dz_rows="all", seed=5):
    """(z, (dh, d_edge_attr, d_ins)) of the composite under autograd and of
    gine_messages, for one dz; ``dz_rows`` 'real' zeroes dz on padded node
    rows."""
    out = []
    dz = None
    for fn in (composite, lambda g, *a: gm.gine_messages(
            *a, *indices(g), npg=g.nodes_per_graph)):
        leaves = [t.clone().requires_grad_(True) for t in (h, ins, edge_attr)]
        z = fn(g, *leaves)
        if dz is None:
            dz = torch.randn(z.shape, generator=torch.Generator().manual_seed(
                seed)).to(z.dtype)
            if dz_rows == "real":
                dz = dz * g.node_mask[:, None]
        dh, d_ins, d_edge = torch.autograd.grad(z, leaves, dz)
        out.append((z.detach(), (dh, d_edge, d_ins)))
    return out


def assert_grad_close(got, want, dtype):
    assert got.dtype == want.dtype
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -6 * float(want.float().abs().max()), err


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_against_the_composite(dtype, rung):
    npg, epg = rung
    g = batch(npg, epg, seed=npg)
    (z_c, grads_c), (z_p, grads_p) = both(g, *inputs(g, DTYPES[dtype], 1))
    assert z_p.dtype == z_c.dtype == gm.messages_dtype(
        *inputs(g, DTYPES[dtype], 1))
    if dtype == "float32":
        torch.testing.assert_close(z_p, z_c, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(z_p, z_c)
    dh, d_edge, d_ins = grads_p
    dh_c, d_edge_c, d_ins_c = grads_c
    assert torch.equal(d_edge, d_edge_c)
    assert_grad_close(dh, dh_c, dtype)
    assert_grad_close(d_ins, d_ins_c, dtype)
    # the rows reach the comparison: some messages are on, some off
    assert 0 < int((d_edge != 0).sum()) < int(g.edge_mask.sum()) * C


@pytest.mark.parametrize("dtype", ["bfloat16", "mixed"])
def test_the_ins_half_is_the_composites_bit_for_bit(dtype):
    npg, epg = RUNGS[0]
    g = batch(npg, epg, seed=3)
    # in-degrees up to epg: the sum of that many equal values is exact
    g_hub = batch(npg, epg, seed=4, sizes=((npg, epg),))
    g_hub.edge_dst[:epg] = 0
    for graph in (g, g_hub):
        h, ins, edge_attr = inputs(graph, DTYPES[dtype], 2)
        want = composite(graph, h, ins, edge_attr)[:, C:]
        got = gm.gine_messages(h, ins, edge_attr, *indices(graph),
                               npg=npg)[:, C:]
        assert torch.equal(got, want)
    assert int((g_hub.edge_dst[:epg] == 0).sum()) == epg


@pytest.mark.parametrize("case", ["no_edges", "all_padded"])
def test_graphs_without_real_edges(case):
    """Every graph without a real edge: z is [h ; ins], dh is dz's first
    columns, d_edge_attr 0 and d_ins the sum of dz's ins columns over the
    graph's rows. 'all_padded' takes a packed batch and masks every edge,
    so the padded rows carry real-looking indices that must be ignored."""
    npg, epg = RUNGS[0]
    if case == "no_edges":
        g = batch(npg, epg, seed=0, sizes=((3, 0), (npg, 0)))
    else:
        g = batch(npg, epg, seed=0)
        g.edge_mask[:] = False
    h, ins, edge_attr = inputs(g, DTYPES["float32"], 0)
    (z_c, grads_c), (z_p, (dh, d_edge, d_ins)) = both(g, h, ins, edge_attr)
    B = g.num_graphs
    x_cat = torch.cat([h, ins.repeat_interleave(npg, dim=0)], dim=-1)
    assert torch.equal(z_p, x_cat) and torch.equal(z_c, x_cat)
    assert not bool(d_edge.any())
    dz = torch.randn(z_p.shape, generator=torch.Generator().manual_seed(5))
    assert torch.equal(dh, dz[:, :C])
    torch.testing.assert_close(d_ins, dz[:, C:].reshape(B, npg, D).sum(1))
    for got, want in zip((dh, d_edge, d_ins), grads_c):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dz_rows", ["real", "all"])
def test_padded_node_rows_of_dz(dz_rows):
    """dz on padded node rows: their broadcast ins columns reach d_ins and
    their own h columns dh, as in the composite; zero there, d_ins takes
    the real rows alone."""
    npg, epg = RUNGS[0]
    g = batch(npg, epg, seed=7)
    h, ins, edge_attr = inputs(g, DTYPES["float32"], 3)
    (_, grads_c), (_, grads_p) = both(g, h, ins, edge_attr, dz_rows=dz_rows)
    for got, want in zip(grads_p, grads_c):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    _, (_, real_only) = both(g, h, ins, edge_attr, dz_rows="real")
    moved = not torch.equal(grads_p[2], real_only[2])
    assert moved == (dz_rows == "all")
    assert not bool(real_only[0][~g.node_mask].any())


@pytest.mark.parametrize("fault", ["unsorted", "padding_first"])
def test_edges_out_of_order_are_refused(fault):
    npg, epg = RUNGS[0]
    g = batch(npg, epg, seed=1)
    dl, sl, mask = indices(g)
    dl, mask = dl.clone(), mask.clone()
    if fault == "unsorted":
        # the first graph's first and last real edges swap destinations
        n = int(mask[0].sum())
        assert int(dl[0, 0]) != int(dl[0, n - 1])
        dl[0, 0], dl[0, n - 1] = dl[0, n - 1].clone(), dl[0, 0].clone()
    else:
        mask[0, 0] = False
    h, ins, edge_attr = inputs(g, DTYPES["float32"], 0)
    with pytest.raises(ValueError, match="sorted by destination"):
        gm.gine_messages(h, ins, edge_attr, dl, sl, mask, npg=npg)


def test_gine_seq_takes_the_pair_on_the_dense_layout_only(monkeypatch):
    """One gine_messages call a round on a dense batch, giving the
    composite's output; none on the flat layout."""
    torch.manual_seed(0)
    seq = GINESeq(C, D, num_rounds=3)
    npg, epg = RUNGS[0]
    g = batch(npg, epg, seed=2)
    h, _, edge_attr = inputs(g, DTYPES["float32"], 4)
    instr = torch.randn(3, g.num_graphs, D)
    calls = []
    real = gnn.gine_messages
    monkeypatch.setattr(gnn, "gine_messages",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    got = seq(g, h, edge_attr, instr)
    assert len(calls) == 3
    monkeypatch.setattr(gnn, "gine_messages", lambda *a, **k: composite(
        g, a[0], a[1], a[2]))
    want = seq(g, h, edge_attr, instr)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    flat = dataclasses.replace(g, nodes_per_graph=0, edges_per_graph=0)
    monkeypatch.setattr(gnn, "gine_messages", lambda *a, **k: pytest.fail(
        "the flat layout took the dense pair"))
    seq(flat, h, edge_attr, instr)


def test_no_launch_is_counted_on_the_cpu():
    npg, epg = RUNGS[0]
    g = batch(npg, epg, seed=0)
    gm.gine_messages(*inputs(g, DTYPES["bfloat16"], 0), *indices(g), npg=npg)
    counts = launch_counts()
    assert counts["gine_messages"] == counts["gine_messages_backward"] == 0
