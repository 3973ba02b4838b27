"""The GAT-round CUDA kernels (forward and backward) against their plain
PyTorch twins, on the card.

Needs an NVIDIA GPU and nvcc; skips without them. Imports no JAX, so it runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

The kernel is held to the plain version's float32 result on the same input
values. Tolerances: f32 rtol/atol 1e-4 (the same f32 sums in another order);
bf16 rtol 2^-8 and atol 1e-5: the kernel accumulates in f32 and rounds its
output once, so half a bf16 ulp plus the f32 reordering is all it may lose.
The backward is held the same way: its float32 outputs (d_alpha_l,
d_alpha_r, d_alpha_e) to rtol/atol 1e-4, its outputs in xw's dtype (d_xw,
d_ins_value) to TOL; two runs of it must agree bit for bit.
"""
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from graphvqa_tpu_torch.core.packing import GraphSample, pack_graphs_dense
from graphvqa_tpu_torch.ops.dense import dense_local_indices
from graphvqa_tpu_torch.ops.gat_round import (
    gat_round, gat_round_backward, gat_round_backward_reference,
    gat_round_reference)
# a top-level import: pytest puts tests/ on sys.path, and the card's machine
# may have another package named `tests`
from torch_port_fixtures import tiny_gat_seq, tiny_train_case

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2.0 ** -8, atol=1e-5)}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


def _inputs(npg, epg, B, H, C, dtype, seed, dev, dummies=2):
    """Ragged graphs with parallel edges, self-loops, a node without
    in-edges per graph and ``dummies`` fully padded graphs at the end."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(B - dummies):
        n = int(rng.integers(2, npg + 1))
        e = int(rng.integers(2, epg + 1))
        src = rng.integers(0, n, size=e).astype(np.int32)
        dst = rng.integers(0, n - 1, size=e).astype(np.int32)
        src[1], dst[1] = src[0], dst[0]
        samples.append(GraphSample(
            node_tokens=np.ones((n, 12), np.int32), edge_src=src,
            edge_dst=dst, edge_tokens=np.ones((e, 1), np.int32),
            edge_sym=np.zeros(e, bool)))
    return _graph_inputs(pack_graphs_dense(samples, npg, epg, num_graphs=B),
                         H, C, dtype, seed, dev)


def _graph_inputs(g, H, C, dtype, seed, dev):
    """Random scores and values on a packed batch ``g``."""
    g = g.to(dev)
    B, npg, epg = g.num_graphs, g.nodes_per_graph, g.edges_per_graph
    dl, sl = dense_local_indices(g)
    mask = g.edge_mask.reshape(B, epg).float()
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    N = B * npg
    return (dl, sl, mask, randn(N, H), randn(N, H), randn(B, epg, H),
            randn(N, H, C).to(dtype)), randn(B, H, C).to(dtype)


def _full_graphs(npg, epg, B, n, seed):
    """B graphs of exactly n nodes whose edges leave and reach the last
    node, so each graph's staged xw rows and g rows are n full rows."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(B):
        e = int(rng.integers(n, epg + 1))
        src = rng.integers(0, n, size=e).astype(np.int32)
        dst = rng.integers(0, n, size=e).astype(np.int32)
        src[0] = dst[1] = n - 1
        samples.append(GraphSample(
            node_tokens=np.ones((n, 12), np.int32), edge_src=src,
            edge_dst=dst, edge_tokens=np.ones((e, 1), np.int32),
            edge_sym=np.zeros(e, bool)))
    return pack_graphs_dense(samples, npg, epg)


def _check(args, ins, npg, epg, shift, dtype):
    before = gat_round.launches
    got = gat_round(*args, ins, npg=npg, epg=epg, shift=shift)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want = gat_round_reference(*f32, None if ins is None else ins.float(),
                               npg=npg, epg=epg, shift=shift)
    torch.cuda.synchronize()
    assert gat_round.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_ins", [False, True])
@pytest.mark.parametrize("shift", ["graph", "dst"])
def test_kernel_matches_plain_version_main_widths(shift, with_ins, dtype):
    """npg=64, epg=256, H=4, C=300 (the main path's widths) on 64 graphs."""
    dev = _device()
    args, ins = _inputs(64, 256, 64, 4, 300, dtype, seed=1, dev=dev)
    _check(args, ins if with_ins else None, 64, 256, shift, dtype)


@pytest.mark.parametrize("npg,epg", [(16, 64), (32, 128), (64, 512),
                                     (128, 1024)])
def test_kernel_matches_plain_version_ladder_rungs(npg, epg):
    """Other rungs of the dense ladders, an odd channel count (scalar loads)
    and another head count."""
    dev = _device()
    args, ins = _inputs(npg, epg, 8, 3, 7, torch.float32, seed=2, dev=dev)
    _check(args, ins, npg, epg, "graph", torch.float32)


@pytest.mark.parametrize("npg,epg,n,dtype", [
    (64, 256, 37, torch.bfloat16),    # 37 rows fill an H100 stage (90 KB)
    (64, 256, 64, torch.bfloat16),    # more rows than a stage: channel chunks
    (64, 256, 64, torch.float32),
    (128, 1024, 128, torch.bfloat16),
    (128, 1024, 128, torch.float32)])
def test_kernel_stage_filling_and_chunked_graphs(npg, epg, n, dtype):
    """Graphs whose real rows fill a whole xw stage, and graphs that need
    more than a stage and go through the chunked path, at C=300, H=4."""
    dev = _device()
    args, ins = _graph_inputs(_full_graphs(npg, epg, 140, n, seed=3), 4, 300,
                              dtype, seed=3, dev=dev)
    for shift in ("graph", "dst"):
        _check(args, ins, npg, epg, shift, dtype)


# The collate's dense ladder doubles the configured padding of nodes
# (64 -> 512) and of edges (256 -> 2048) independently: every pair is a rung.
LADDER = [(npg, epg) for npg in (64, 128, 256, 512)
          for epg in (256, 512, 1024, 2048)]


def _rung_graphs(npg, epg, seed):
    """Graphs for one rung of the ladder: one of exactly npg nodes whose
    edges fill the rung, ragged ones, and a dummy graph at the end."""
    rng = np.random.default_rng(seed)
    samples = []
    for k in range(6):
        n = npg if k == 0 else int(rng.integers(npg // 2 + 1, npg + 1))
        e = epg if k == 0 else int(rng.integers(min(n, epg), epg + 1))
        src = rng.integers(0, n, size=e).astype(np.int32)
        dst = rng.integers(0, n, size=e).astype(np.int32)
        src[0] = dst[1] = n - 1
        samples.append(GraphSample(
            node_tokens=np.ones((n, 12), np.int32), edge_src=src,
            edge_dst=dst, edge_tokens=np.ones((e, 1), np.int32),
            edge_sym=np.zeros(e, bool)))
    return pack_graphs_dense(samples, npg, epg, num_graphs=7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("npg,epg", LADDER)
def test_kernel_every_ladder_rung_at_full_width(npg, epg, dtype):
    """Every (npg, epg) rung the collate can produce, up to (512, 2048), at
    H=4, C=300 in both dtypes: a full graph and ragged ones, the training
    options (dropout scale, attention output) and both shifts."""
    dev = _device()
    args, ins = _graph_inputs(_rung_graphs(npg, epg, seed=npg + epg), 4, 300,
                              dtype, seed=40, dev=dev)
    _check(args, ins, npg, epg, "graph", dtype)
    _check(args, None, npg, epg, "dst", dtype)
    keep = _keep(args, 0.1, seed=41)
    out, alpha = gat_round(*args, ins, npg=npg, epg=epg, keep_scale=keep,
                           return_alpha=True)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want, want_alpha = gat_round_reference(
        *f32, ins.float(), npg=npg, epg=epg, keep_scale=keep,
        return_alpha=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want, **TOL[dtype])
    torch.testing.assert_close(alpha.float(), want_alpha, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("npg,epg", LADDER)
def test_backward_every_ladder_rung_at_full_width(npg, epg, dtype):
    """The backward at every rung of the ladder, H=4, C=300, both dtypes,
    with the dropout scale and the instruction share, both shifts."""
    dev = _device()
    args, ins = _graph_inputs(_rung_graphs(npg, epg, seed=npg + epg), 4, 300,
                              dtype, seed=42, dev=dev)
    keep = _keep(args, 0.1, seed=43)
    for shift in ("graph", "dst"):
        _check_backward(args, ins, keep, npg, epg, shift, dtype)
    assert int(gat_round_backward.counter) == 7 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("npg,epg", [(256, 1024), (512, 2048)])
def test_top_rungs_several_graphs_per_block(npg, epg, dtype):
    """The top rungs fit one block per SM, so with 300 full graphs every
    block of the persistent grid takes two or three in turn and reuses its
    stages and barriers: forward and backward against the plain versions."""
    dev = _device()
    args, ins = _graph_inputs(_full_graphs(npg, epg, 300, npg, seed=7), 4,
                              300, dtype, seed=44, dev=dev)
    keep = _keep(args, 0.1, seed=45)
    _check(args, ins, npg, epg, "graph", dtype)
    _check_backward(args, ins, keep, npg, epg, "graph", dtype)


@pytest.mark.parametrize("B", [1, 7, 133, 400])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_graph_counts_around_the_persistent_grid(B, dtype):
    """B below the persistent grid (two blocks per SM), not a multiple of
    it, and several graphs per block (the ring of stages turns over), with
    graphs without real edges in the middle and dummy graphs at the end."""
    dev = _device()
    args, ins = _inputs(64, 256, B, 4, 300, dtype, seed=4, dev=dev,
                        dummies=min(2, B - 1))
    args[2][1::5] = 0.0           # graphs 1, 6, 11, ...: no real edge
    _check(args, ins, 64, 256, "graph", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_odd_channels_many_graphs(dtype):
    """C=7 (scalar loads and stores) over more graphs than the grid."""
    dev = _device()
    args, ins = _inputs(32, 128, 300, 4, 7, dtype, seed=5, dev=dev)
    _check(args, ins, 32, 128, "dst", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_unaligned_xw_and_ins(dtype):
    """xw and ins sliced one element into a larger buffer: no 16-byte bulk
    copy is possible, so the rows come through the fallback copy, and the
    misaligned ins forces one channel per thread."""
    dev = _device()
    args, ins = _inputs(64, 256, 140, 4, 300, dtype, seed=6, dev=dev)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    xw, ins = shifted(args[6]), shifted(ins)
    assert xw.data_ptr() % 16 != 0 and ins.data_ptr() % 16 != 0
    _check(args[:6] + (xw,), ins, 64, 256, "graph", dtype)


def test_kernel_replays_in_a_cuda_graph():
    """Captured once and replayed twice: the graph counter is zeroed by a node
    of the captured graph, so every replay hands every graph out again."""
    dev = _device()
    args, ins = _inputs(64, 256, 300, 4, 300, torch.bfloat16, seed=7, dev=dev)
    kw = dict(npg=64, epg=256, shift="graph")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gat_round(*args, ins, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = gat_round(*args, ins, **kw)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want = gat_round_reference(*f32, ins.float(), **kw)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **TOL[torch.bfloat16])


def test_gat_seq_float32_on_the_card():
    """The f32 engine on the card against the same module on the CPU (the
    kernel needs a contiguous xw in every dtype)."""
    dev = _device()
    seq, g, x, e, ins = tiny_gat_seq(torch.float32)
    with torch.no_grad():
        want = seq(g, x, e, ins)
        got = seq.to(dev)(g.to(dev), x.to(dev), e.to(dev), ins.to(dev))
    torch.cuda.synchronize()
    mask = g.node_mask
    torch.testing.assert_close(got.cpu()[mask], want[mask], rtol=1e-4,
                               atol=1e-4)


def test_kernel_stops_on_unsorted_edges():
    """Edges out of the dense packing's order trip the kernel's device
    assert. The assert ends the CUDA context, so it runs in a subprocess."""
    _device()
    script = textwrap.dedent("""
        import torch
        from graphvqa_tpu_torch.ops.gat_round import gat_round
        dev = torch.device("cuda")
        dl = torch.tensor([[1, 0, 0, 0]], dtype=torch.int32, device=dev)
        sl = torch.zeros(1, 4, dtype=torch.int32, device=dev)
        mask = torch.tensor([[1.0, 1.0, 0.0, 0.0]], device=dev)
        z = lambda *s: torch.zeros(*s, device=dev)
        gat_round(dl, sl, mask, z(2, 1), z(2, 1), z(1, 4, 1), z(2, 1, 4),
                  npg=2, epg=4)
        torch.cuda.synchronize()
        print("no assert")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300,
                          cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode != 0, proc.stdout
    assert "assert" in proc.stderr.lower(), proc.stderr[-2000:]


def _keep(args, rate, seed):
    """A dropout scale [B, epg, H] (0 or 1/(1-rate)) for the inputs."""
    B, epg, H = args[5].shape
    gen = torch.Generator(device=args[0].device).manual_seed(seed)
    keep = torch.rand(B, epg, H, generator=gen, device=args[0].device)
    return (keep >= rate).float() / (1.0 - rate)


def _check_backward(args, ins, keep, npg, epg, shift, dtype, seed=0):
    dev = args[0].device
    N, _, C = args[6].shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    grad = torch.randn(N, C, generator=gen, device=dev).to(dtype)
    before = gat_round_backward.launches
    got = gat_round_backward(grad, *args, ins, keep, npg=npg, epg=epg,
                             shift=shift)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want = gat_round_backward_reference(
        grad.float(), *f32, None if ins is None else ins.float(), keep,
        npg=npg, epg=epg, shift=shift)
    torch.cuda.synchronize()
    assert gat_round_backward.launches == before + 1
    names = ("d_xw", "d_alpha_l", "d_alpha_r", "d_alpha_e", "d_ins_value")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None
            continue
        assert torch.isfinite(g).all(), name
        tol = TOL[dtype] if name in ("d_xw", "d_ins_value") else TOL[
            torch.float32]
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=name)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("with_ins", [False, True])
@pytest.mark.parametrize("shift", ["graph", "dst"])
def test_backward_matches_plain_version_main_widths(shift, with_ins,
                                                    with_keep, dtype):
    """npg=64, epg=256, H=4, C=300 on 64 graphs, with and without the
    instruction share and the attention dropout scale."""
    dev = _device()
    args, ins = _inputs(64, 256, 64, 4, 300, dtype, seed=11, dev=dev)
    keep = _keep(args, 0.1, seed=12) if with_keep else None
    _check_backward(args, ins if with_ins else None, keep, 64, 256, shift,
                    dtype)


@pytest.mark.parametrize("npg,epg", [(16, 64), (32, 128), (64, 512),
                                     (128, 1024)])
def test_backward_ladder_rungs(npg, epg):
    """Other rungs, an odd channel count and another head count."""
    dev = _device()
    args, ins = _inputs(npg, epg, 8, 3, 7, torch.float32, seed=13, dev=dev)
    _check_backward(args, ins, _keep(args, 0.2, seed=14), npg, epg, "dst",
                    torch.float32)


@pytest.mark.parametrize("npg,epg,n,dtype", [
    (64, 256, 64, torch.bfloat16), (64, 256, 64, torch.float32),
    (128, 1024, 128, torch.bfloat16)])
def test_backward_full_graphs(npg, epg, n, dtype):
    """Graphs of npg real nodes (the forward's chunked case)."""
    dev = _device()
    args, ins = _graph_inputs(_full_graphs(npg, epg, 40, n, seed=15), 4, 300,
                              dtype, seed=15, dev=dev)
    for shift in ("graph", "dst"):
        _check_backward(args, ins, None, npg, epg, shift, dtype)


@pytest.mark.parametrize("npg,epg,n,dtype", [
    # on an H100 (two blocks per SM): 55 xw rows, ins and 55 g rows fill the
    # tensor-core stage (93,312 of 93,840 bytes); 56 take the packed path
    (64, 256, 55, torch.bfloat16), (64, 256, 56, torch.bfloat16),
    # 38 + 38 f32 rows fill the stage; 39 + 39 go in 3 channel chunks
    (64, 256, 38, torch.float32), (64, 256, 39, torch.float32),
    # the ring of chunks: 10 of 32 channels in bf16, 19 of 16 in f32
    (128, 1024, 128, torch.bfloat16), (128, 1024, 128, torch.float32)])
def test_backward_stage_filling_and_chunked_graphs(npg, epg, n, dtype):
    """Units whose staged rows (n xw rows of one head, n g rows) fill the
    row stage, and units one row past it or far past it, whose channels go
    through the two-stage ring of chunks, at C=300, H=4."""
    dev = _device()
    args, ins = _graph_inputs(_full_graphs(npg, epg, 40, n, seed=24), 4, 300,
                              dtype, seed=24, dev=dev)
    keep = _keep(args, 0.1, seed=25)
    for shift in ("graph", "dst"):
        _check_backward(args, ins, keep, npg, epg, shift, dtype)


@pytest.mark.parametrize("B", [1, 7, 133, 400])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_graph_counts_around_the_persistent_grid(B, dtype):
    """B*H (graph, head) units below the persistent grid (two blocks per
    SM), not a multiple of it, and several units per block (the meta ring
    turns over), with graphs without real edges in the middle and dummy
    graphs at the end; the counter ends holding B*H."""
    dev = _device()
    args, ins = _inputs(64, 256, B, 4, 300, dtype, seed=26, dev=dev,
                        dummies=min(2, B - 1))
    args[2][1::5] = 0.0
    _check_backward(args, ins, _keep(args, 0.1, seed=27), 64, 256, "graph",
                    dtype)
    assert int(gat_round_backward.counter) == B * 4


@pytest.mark.parametrize("H,C", [(1, 300), (6, 36)])
def test_backward_other_head_counts(H, C):
    """Another head count with C a multiple of 4 (the vector path)."""
    dev = _device()
    args, ins = _inputs(64, 256, 50, H, C, torch.bfloat16, seed=28, dev=dev)
    _check_backward(args, ins, _keep(args, 0.1, seed=29), 64, 256, "dst",
                    torch.bfloat16)


def test_backward_replays_in_a_cuda_graph():
    """Captured once and replayed twice against the plain version: the work
    counter is zeroed by a node of the captured graph, so every replay hands
    every unit out again, and the replays equal an eager call bit for bit."""
    dev = _device()
    args, ins = _inputs(64, 256, 300, 4, 300, torch.bfloat16, seed=30,
                        dev=dev)
    keep = _keep(args, 0.1, seed=31)
    grad = torch.randn(args[6].shape[0], 300, device=dev).bfloat16()
    kw = dict(npg=64, epg=256, shift="graph")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = gat_round_backward(grad, *args, ins, keep, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = gat_round_backward(grad, *args, ins, keep, **kw)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want = gat_round_backward_reference(grad.float(), *f32, ins.float(), keep,
                                        **kw)
    for _ in range(2):
        for t in got:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for g, w, e in zip(got, want, eager):
            tol = TOL[torch.bfloat16] if g.dtype == torch.bfloat16 else TOL[
                torch.float32]
            torch.testing.assert_close(g.float(), w.float(), **tol)
            assert torch.equal(g, e)


@pytest.mark.parametrize("B", [1, 7, 133])
def test_backward_graphs_without_edges(B):
    """Graphs without real edges and dummy graphs get exact zeros."""
    dev = _device()
    args, ins = _inputs(64, 256, B, 4, 300, torch.bfloat16, seed=16,
                        dev=dev, dummies=min(2, B - 1))
    args[2][1::5] = 0.0
    got = _check_backward(args, ins, None, 64, 256, "graph", torch.bfloat16)
    empty = (args[2].sum(dim=1) == 0).nonzero().flatten()
    d_xw = got[0].reshape(B, 64, 4, 300)
    assert (d_xw[empty] == 0).all() and (got[3][empty] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_unaligned_inputs(dtype):
    """xw, ins and the upstream gradient sliced one element into larger
    buffers."""
    dev = _device()
    args, ins = _inputs(64, 256, 40, 4, 300, dtype, seed=17, dev=dev)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    _check_backward(args[:6] + (shifted(args[6]),), shifted(ins), None, 64,
                    256, "graph", dtype)


def test_backward_runs_agree_bit_for_bit():
    dev = _device()
    args, ins = _inputs(64, 256, 300, 4, 300, torch.bfloat16, seed=18,
                        dev=dev)
    keep = _keep(args, 0.1, seed=19)
    grad = torch.randn(args[6].shape[0], 300, device=dev).bfloat16()
    first = gat_round_backward(grad, *args, ins, keep, npg=64, epg=256)
    second = gat_round_backward(grad, *args, ins, keep, npg=64, epg=256)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_with_dropout_scale_and_attention(dtype):
    """The training options of the forward kernel against the twin: the
    dropout scale and the attention output (0 on padded edges)."""
    dev = _device()
    args, ins = _inputs(64, 256, 140, 4, 300, dtype, seed=20, dev=dev)
    keep = _keep(args, 0.1, seed=21)
    out, alpha = gat_round(*args, ins, npg=64, epg=256, keep_scale=keep,
                           return_alpha=True)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want, want_alpha = gat_round_reference(
        *f32, ins.float(), npg=64, epg=256, keep_scale=keep,
        return_alpha=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want, **TOL[dtype])
    torch.testing.assert_close(alpha.float(), want_alpha, **TOL[dtype])
    assert alpha.dtype == dtype
    assert (alpha[args[2].reshape(-1) == 0] == 0).all()


def test_autograd_through_both_kernels():
    """gat_round with inputs that require grad: one forward and one backward
    launch, and the gradients of the plain version's autograd."""
    dev = _device()
    args, ins = _inputs(64, 256, 64, 4, 300, torch.float32, seed=22, dev=dev)
    keep = _keep(args, 0.1, seed=23)
    grad = torch.randn(args[6].shape[0], 300, device=dev)

    def run(fn):
        leaves = [a.clone().requires_grad_(True) for a in args[3:]]
        ins_ = ins.clone().requires_grad_(True)
        out = fn(*args[:3], *leaves, ins_, npg=64, epg=256, keep_scale=keep)
        out.backward(grad)
        return [t.grad for t in leaves + [ins_]]

    f0, b0 = gat_round.launches, gat_round_backward.launches
    got = run(gat_round)
    assert (gat_round.launches - f0, gat_round_backward.launches - b0) == (
        1, 1)
    want = run(gat_round_reference)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_train_step_on_the_card_matches_the_cpu():
    """One float32 train step of a small model, card against CPU from the
    same weights (dropout 0): loss to rtol 1e-5, gradients within 1e-4 of
    each tensor's largest |gradient| plus 1e-7, updated parameters to 1e-6
    where the CPU's |gradient| > 1e-5, both kernels launched once per round.
    """
    from graphvqa_tpu_torch.models.pipeline import build_model
    from graphvqa_tpu_torch.train.loop import make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    dev = _device()
    cfg, batch = tiny_train_case()
    runs = []
    for device in ("cpu", dev):
        model = build_model(cfg.model, device=device, seed=3)
        state = create_train_state(model, lr=1e-3)
        f0, b0 = gat_round.launches, gat_round_backward.launches
        _, m = make_train_step(model, cfg)(
            state, batch.to(device), torch.Generator(device=device))
        launched = (gat_round.launches - f0, gat_round_backward.launches - b0)
        runs.append((float(m["total"]), launched, {
            n: (p.detach().cpu(), None if p.grad is None else p.grad.cpu())
            for n, p in model.named_parameters()}))
    (loss_c, launched_c, cpu), (loss_g, launched_g, gpu) = runs
    rounds = cfg.model.engine.num_rounds
    assert launched_c == (0, 0) and launched_g == (rounds, rounds)
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-5)
    for n, (p_c, g_c) in cpu.items():
        p_g, g_g = gpu[n]
        if g_c is None:
            assert g_g is None, n
            continue
        torch.testing.assert_close(g_g, g_c, rtol=0, msg=n,
                                   atol=1e-4 * float(g_c.abs().max()) + 1e-7)
        ok = g_c.abs() > 1e-5
        torch.testing.assert_close(p_g[ok], p_c[ok], rtol=0, atol=1e-6,
                                   msg=n)


@pytest.mark.parametrize("layout", ["dense", "flat_fallback"])
def test_collated_batch_through_eval_and_train_steps(layout):
    """One batch of the debug fixture collated by the port's dataset, in the
    configured dense shape or forced into the flat layout, through the eval
    and the train step of a --tiny float32 model on the card: the eval
    logits within 1e-4 of the CPU's, a finite loss, and both kernels
    launched once per round on the dense batch, never on the flat one."""
    from graphvqa_tpu_torch.cli.train_cli import build_config, get_args_parser
    from graphvqa_tpu_torch.data import (
        GQADataset, build_scene_graph_vocab, build_text_vocab, tokenize)
    from graphvqa_tpu_torch.models.pipeline import build_model
    from graphvqa_tpu_torch.train.loop import make_eval_step, make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    dev = _device()
    debug = pathlib.Path(__file__).resolve().parents[1] / (
        "graphvqa_tpu_torch/assets/debug")
    programs = debug / "debug_programs.json"
    tv = build_text_vocab(
        __import__("json").loads(programs.read_text()), tokenize)
    sgv = build_scene_graph_vocab()
    widths = ["--nodes-per-graph", "2", "--edges-per-graph", "8",
              "--nodes-pad", "256", "--edges-pad", "1024"] if (
        layout == "flat_fallback") else []
    cfg = build_config(get_args_parser().parse_args(
        ["--data-root", ".", "--tiny", "--batch-size", "4", "--dtype",
         "float32"] + widths), len(tv), len(sgv))
    ds = GQADataset(programs, debug / "debug_sceneGraphs.json", tv, sgv)
    meta, batch = next(ds.iter_batches(cfg.batch))
    assert meta["layout"] == layout
    rounds = cfg.model.engine.num_rounds
    kernels = rounds if layout == "dense" else 0
    logits = []
    for device in ("cpu", dev):
        model = build_model(cfg.model, device=device, seed=5)
        f0 = gat_round.launches
        vectors, tokens, _ = make_eval_step(model, cfg)(batch.to(device))
        logits.append(vectors["sa_score"].cpu())
        if device != "cpu":
            assert gat_round.launches - f0 == kernels
            f0, b0 = gat_round.launches, gat_round_backward.launches
            _, m = make_train_step(model, cfg)(
                create_train_state(model), batch.to(device),
                torch.Generator(device=device).manual_seed(0))
            torch.cuda.synchronize()
            assert torch.isfinite(m["total"])
            assert (gat_round.launches - f0,
                    gat_round_backward.launches - b0) == (kernels, kernels)
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["gcn", "gine", "lcgn", "onlysg",
                                    "gat_exec"])
def test_every_family_card_against_cpu(family):
    """Each engine family (and gat with the execution engine) at tiny width
    in float32: the eval logits (and the bitmap) within 1e-4 of the CPU's;
    one train step's loss to rtol 1e-5 and every gradient within 1e-4 of its
    tensor's largest |gradient| + 1e-7; the GAT kernels launch once per
    round on onlysg and gat, never on gcn, gine and lcgn. LCGN's context
    features are one fixed draw on both sides."""
    import dataclasses
    import functools
    from graphvqa_tpu_torch.models.pipeline import build_model
    from graphvqa_tpu_torch.train.loop import make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    dev = _device()
    cfg, batch = tiny_train_case()
    kind = {"onlysg": "none", "gat_exec": "gat"}.get(family, family)
    exe = family == "gat_exec"
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model.replace_engine(kind),
                                       use_execution_engine=exe),
        train=dataclasses.replace(cfg.train, use_program_loss=True,
                                  use_bitmap_loss=exe))
    noise = torch.randn(batch.graphs.nodes_pad, cfg.model.transformer.hidden_dim,
                        generator=torch.Generator().manual_seed(0))
    rounds = cfg.model.engine.num_rounds if kind in ("gat", "none") else 0
    runs = []
    for device in ("cpu", dev):
        model = build_model(cfg.model, device=device, seed=3)
        if kind == "lcgn":
            model.lcgn_seq.forward = functools.partial(
                model.lcgn_seq.forward, x_ctx=noise.to(device))
        f0 = gat_round.launches
        out = model.sample(batch.to(device))
        launched = gat_round.launches - f0
        f0, b0 = gat_round.launches, gat_round_backward.launches
        _, m = make_train_step(model, cfg)(
            create_train_state(model, lr=1e-3), batch.to(device),
            torch.Generator(device=device))
        launched = (launched, gat_round.launches - f0,
                    gat_round_backward.launches - b0)
        bitmap = out.execution_bitmap
        runs.append((out.short_answer_logits.cpu(),
                     None if bitmap is None else bitmap.cpu(),
                     float(m["total"]), launched,
                     {n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None}))
    (lc, bc, loss_c, launched_c, gc), (lg, bg, loss_g, launched_g, gg) = runs
    assert launched_c == (0, 0, 0)
    assert launched_g == (rounds, rounds, rounds)
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    if exe:
        torch.testing.assert_close(bg, bc, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-5)
    assert set(gg) == set(gc)
    for n, g_c in gc.items():
        torch.testing.assert_close(gg[n], g_c, rtol=0, msg=n,
                                   atol=1e-4 * float(g_c.abs().max()) + 1e-7)


def _single_steps(cfg, batches, dev, lr):
    """The single-process float32 step on the card on each batch, from the
    same weights: (gradients by name, loss) per batch, and the parameters
    that Adam gives from the mean of those gradients."""
    from graphvqa_tpu_torch.models.pipeline import build_model
    from graphvqa_tpu_torch.train.loop import forward_backward
    from graphvqa_tpu_torch.train.train_state import create_train_state
    runs = []
    for batch in batches:
        model = build_model(cfg.model, device=dev, seed=3)
        m = forward_backward(model, cfg, batch.to(dev),
                             torch.Generator(device=dev))
        runs.append(({n: (torch.zeros_like(p) if p.grad is None
                          else p.grad).cpu()
                      for n, p in model.named_parameters()},
                     float(m["total"])))
    mean = {n: sum(r[0][n] for r in runs) / len(runs) for n in runs[0][0]}
    model = build_model(cfg.model, device=dev, seed=3)
    create_train_state(model, lr=lr).apply_gradients(
        {n: g.to(dev) for n, g in mean.items()})
    return runs, mean, {n: p.detach().cpu()
                        for n, p in model.named_parameters()}


def _spawn_train(cfg, batches, data, edge, tmp_path):
    """One train step of ``data`` x ``edge`` gloo ranks sharing the card
    (tests/torch_port_dist.py), from the same weights as _single_steps."""
    from graphvqa_tpu_torch.models.pipeline import build_model
    import torch_port_dist
    sd = build_model(cfg.model, device="cpu", seed=3).state_dict()
    case = dict(kind="train", data=data, edge=edge, cfg=cfg, state_dict=sd,
                lr=1e-3, wd=0.0, batches=[[b] for b in batches])
    return [r[0] for r in torch_port_dist.spawn(data * edge, tmp_path, [case],
                                                device="cuda")]


def _close_grads(got, want, n):
    torch.testing.assert_close(got, want, rtol=0, msg=n,
                               atol=1e-4 * float(want.abs().max()) + 1e-7)


def test_data_parallel_step_two_ranks_share_the_card(tmp_path):
    """Two gloo ranks on the one card, each on its own batch: each rank's
    own gradient equals the single-process step's on its batch (within 1e-4
    of each tensor's largest |gradient| plus 1e-7: index_add_ on the card
    sums in no fixed order), the parameters after the step the Adam step of
    their mean (1e-6 where |gradient| > 1e-5), and both kernels launch once
    per round on each rank."""
    dev = _device()
    cfg, b0 = tiny_train_case(seed=0)
    _, b1 = tiny_train_case(seed=1)
    runs, mean, params = _single_steps(cfg, [b0, b1], dev, lr=1e-3)
    ranks = _spawn_train(cfg, [b0, b1], 2, 1, tmp_path)
    rounds = cfg.model.engine.num_rounds
    for (grads, _), got in zip(runs, ranks):
        assert got["launches"] == (rounds, rounds)
        np.testing.assert_allclose(got["metrics"]["total"],
                                   (runs[0][1] + runs[1][1]) / 2, rtol=1e-5)
        for n, g in grads.items():
            _close_grads(torch.zeros_like(g) if got["grads"][n] is None
                         else got["grads"][n], g, n)
            ok = mean[n].abs() > 1e-5
            torch.testing.assert_close(got["params"][n][ok], params[n][ok],
                                       rtol=0, atol=1e-6, msg=n)


def test_edge_sharded_step_two_ranks_share_the_card(tmp_path):
    """Data 1 x edge 2 on the one card: the two ranks' gradient shares sum
    to the single-process step's gradient (the bound above), the ranks end
    with equal parameters, and both kernels launch once per round on each
    rank's share of the edges."""
    dev = _device()
    cfg, batch = tiny_train_case(seed=0)
    runs, _, params = _single_steps(cfg, [batch], dev, lr=1e-3)
    r0, r1 = _spawn_train(cfg, [batch], 1, 2, tmp_path)
    rounds = cfg.model.engine.num_rounds
    assert r0["launches"] == r1["launches"] == (rounds, rounds)
    assert r0["epg_loc"] == [batch.graphs.edges_per_graph // 2]
    np.testing.assert_allclose(r0["metrics"]["total"], runs[0][1], rtol=1e-5)
    for n, g in runs[0][0].items():
        share = [torch.zeros_like(g) if r["grads"][n] is None
                 else r["grads"][n] for r in (r0, r1)]
        _close_grads(share[0] + share[1], g, n)
        assert torch.equal(r0["params"][n], r1["params"][n]), n
        ok = g.abs() > 1e-5
        torch.testing.assert_close(r0["params"][n][ok], params[n][ok],
                                   rtol=0, atol=1e-6, msg=n)
