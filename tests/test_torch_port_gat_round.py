"""The port's GAT round against the JAX package.

``gat_round_reference`` (the CUDA kernel's plain twin) is held to the Pallas
kernel in interpret mode and to ``ops/dense.py:dense_gat_aggregate`` under
both softmax shifts, on ragged graphs with dummy graphs, parallel edges and
nodes without in-edges, at the npg/epg rungs 8/16 and 64/256. Tolerance:
rtol 1e-5, atol 1e-5 in float32 (the same sums in another order). The
kernel itself is held to the twin on the card in test_torch_port_cuda.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvqa_tpu.ops.dense as jdense
from graphvqa_tpu.core import GraphSample as JaxGraphSample
from graphvqa_tpu.core import pack_graphs_dense as jax_pack_graphs_dense
from graphvqa_tpu.ops.pallas.fused_dense_gat import pallas_fused_dense_gat
from graphvqa_tpu_torch.core.packing import GraphSample, pack_graphs_dense
from graphvqa_tpu_torch.ops.cuda_lib import KINDS, launch_counts
from graphvqa_tpu_torch.ops.dense import (
    dense_local_indices, edges_dst_sorted)
from graphvqa_tpu_torch.ops.gat_round import gat_round, gat_round_reference
from tests.torch_port_helpers import port_graph

RUNGS = [(8, 16), (64, 256)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _samples(rng, npg, epg, count):
    """Ragged graphs: the last node never receives an edge, and the first
    edge is repeated (a parallel edge)."""
    out = []
    for _ in range(count):
        n = int(rng.integers(3, npg + 1))
        e = int(rng.integers(4, epg))
        src = rng.integers(0, n, size=e).astype(np.int32)
        dst = rng.integers(0, n - 1, size=e).astype(np.int32)
        src[1], dst[1] = src[0], dst[0]
        out.append(dict(
            node_tokens=rng.integers(2, 40, size=(n, 12)).astype(np.int32),
            edge_src=src, edge_dst=dst,
            edge_tokens=rng.integers(2, 40, size=(e, 1)).astype(np.int32),
            edge_sym=rng.random(e) > 0.7))
    return out


def _case(npg, epg, seed, H=2, C=12, real=3, dummies=2):
    rng = np.random.default_rng(seed)
    raw = _samples(rng, npg, epg, real)
    B = real + dummies
    jg = jax.tree.map(jnp.asarray, jax_pack_graphs_dense(
        [JaxGraphSample(**s) for s in raw], npg, epg, num_graphs=B))
    N, E = B * npg, B * epg
    arrays = dict(
        xw=rng.normal(size=(N, H, C)).astype(np.float32),
        al=rng.normal(size=(N, H)).astype(np.float32),
        ar=rng.normal(size=(N, H)).astype(np.float32),
        ae=rng.normal(size=(E, H)).astype(np.float32),
        ins=rng.normal(size=(B, H, C)).astype(np.float32))
    return raw, jg, arrays


def _port_inputs(jg, a):
    g = port_graph(jg)
    B, epg = g.num_graphs, g.edges_per_graph
    H = a["al"].shape[1]
    dl, sl = dense_local_indices(g)
    mask = g.edge_mask.reshape(B, epg).float()
    t = torch.from_numpy
    return g, (dl, sl, mask, t(a["al"]), t(a["ar"]),
               t(a["ae"]).reshape(B, epg, H), t(a["xw"]))


@pytest.mark.parametrize("npg,epg", RUNGS)
def test_port_packing_matches_jax(npg, epg):
    raw, jg, _ = _case(npg, epg, seed=1)
    pg = pack_graphs_dense([GraphSample(**s) for s in raw], npg, epg,
                           num_graphs=jg.num_graphs)
    for f in dataclasses.fields(pg):
        # the port marks an edge-sharded batch by its process group, JAX by
        # its mesh axis name: None on both for an unsharded batch
        want = getattr(jg, {"edge_group": "edge_axis"}.get(f.name, f.name))
        got = getattr(pg, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
        else:
            assert got == want, f.name


@pytest.mark.parametrize("npg,epg", RUNGS)
def test_reference_matches_pallas_interpret(npg, epg):
    _, jg, a = _case(npg, epg, seed=2)
    g, args = _port_inputs(jg, a)
    B, N = g.num_graphs, g.nodes_pad
    H, C = a["al"].shape[1], a["xw"].shape[2]
    dl, sl, mask = args[:3]
    want = pallas_fused_dense_gat(
        jnp.asarray(dl.numpy()), jnp.asarray(sl.numpy()),
        jnp.asarray(mask.numpy()), jnp.asarray(a["al"]), jnp.asarray(a["ar"]),
        jnp.asarray(a["ae"]).reshape(B, epg, H),
        jnp.asarray(a["xw"]).reshape(N, H * C),
        npg=npg, epg=epg, H=H, C=C, graphs_per_step=1, interpret=True)
    want = np.asarray(want).reshape(N, H, C).mean(axis=1)
    got = gat_round_reference(*args, npg=npg, epg=epg, shift="dst").numpy()
    real = np.asarray(jg.node_mask)
    np.testing.assert_allclose(got[real], want[real], **TOL)


@pytest.mark.parametrize("shift", ["graph", "dst"])
@pytest.mark.parametrize("npg,epg", RUNGS)
def test_reference_matches_dense_gat_aggregate(npg, epg, shift, monkeypatch):
    monkeypatch.setattr(jdense, "_SOFTMAX_SHIFT", shift)
    _, jg, a = _case(npg, epg, seed=3)
    want, _ = jdense.dense_gat_aggregate(
        jg, jnp.asarray(a["xw"]), jnp.asarray(a["al"]), jnp.asarray(a["ar"]),
        jnp.asarray(a["ae"]), ins_value=jnp.asarray(a["ins"]))
    _, args = _port_inputs(jg, a)
    got = gat_round_reference(*args, torch.from_numpy(a["ins"]), npg=npg,
                              epg=epg, shift=shift).numpy()
    real = np.asarray(jg.node_mask)
    np.testing.assert_allclose(got[real], np.asarray(want)[real], **TOL)
    # a destination with no in-edges gets exactly its zero aggregate
    no_in = real.copy()
    no_in[np.asarray(jg.edge_dst)[np.asarray(jg.edge_mask)]] = False
    assert no_in.any()
    np.testing.assert_array_equal(got[no_in], 0.0)


def test_wrapper_runs_plain_version_on_cpu_only():
    _, jg, a = _case(8, 16, seed=4)
    _, args = _port_inputs(jg, a)
    before = launch_counts()
    got = gat_round(*args, npg=8, epg=16)
    want = gat_round_reference(*args, npg=8, epg=16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # no kernel on the CPU
    assert launch_counts() == before == dict.fromkeys(KINDS, 0)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        gat_round(*meta, npg=8, epg=16)


@pytest.mark.parametrize("defect", ["unsorted", "padding_first"])
def test_wrapper_rejects_edges_out_of_packing_order(defect):
    """The kernel walks each destination's run of edges, so the wrapper takes
    only the dense packing's order: real edges dst-sorted, padding last."""
    _, jg, a = _case(8, 16, seed=5)
    _, args = _port_inputs(jg, a)
    dl, sl, mask = args[:3]
    assert edges_dst_sorted(dl, sl, mask, 8)
    dl, mask = dl.clone(), mask.clone()
    if defect == "unsorted":             # the first two edges are real
        dl[0, 0], dl[0, 1] = 7, 0
    else:
        mask[0, 0] = 0.0
    assert not edges_dst_sorted(dl, sl, mask, 8)
    with pytest.raises(ValueError, match="sorted by destination"):
        gat_round(dl, sl, mask, *args[3:], npg=8, epg=16)
