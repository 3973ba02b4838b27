"""The port's CUDA kernels (the GAT round, the Transformer stacks'
LayerNorm and the GINE round's messages and sum, forward and backward)
against their plain PyTorch twins, on the card.

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
from graphvqa_tpu_torch.ops.cuda_lib import launch_counts
from graphvqa_tpu_torch.ops.dense import dense_local_indices
from graphvqa_tpu_torch.ops.gat_round import (
    _backward_launch, gat_round, gat_round_backward,
    gat_round_backward_reference, gat_round_reference)
from graphvqa_tpu_torch.ops import gine_messages as gm
from graphvqa_tpu_torch.ops import row_layer_norm as rln
# a top-level import: pytest puts tests/ on sys.path, and the card's machine
# may have another package named `tests`
from torch_port_fixtures import (LAYER_NORM_ULPS, layer_norm_errors,
                                 layer_norm_rows, layer_norm_stats,
                                 round_off_share, scene_law_mask,
                                 tiny_gat_seq, tiny_train_case)

pytestmark = pytest.mark.cuda
# the kinds of launch each kernel pair counts on the card
GAT = ("gat_round", "gat_round_backward")
LN = ("layer_norm", "layer_norm_backward")
GINE = ("gine_messages", "gine_messages_backward")


def _since(before, kinds):
    """Each of ``kinds``' launches since ``before``, a launch_counts()
    reading (the call waits for the card)."""
    now = launch_counts()
    return tuple(now[kind] - before[kind] for kind in kinds)
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
    before = launch_counts()
    got = gat_round(*args, ins, npg=npg, epg=epg, shift=shift)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want = gat_round_reference(*f32, None if ins is None else ins.float(),
                               npg=npg, epg=epg, shift=shift)
    torch.cuda.synchronize()
    assert _since(before, GAT) == (1, 0)
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
        _, counter = _check_backward(args, ins, keep, npg, epg, shift, dtype)
        assert int(counter) == 7 * 4


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
    of the captured graph, so every replay hands every graph out again; the
    replays count their launches on the card, the capture none."""
    dev = _device()
    args, ins = _inputs(64, 256, 300, 4, 300, torch.bfloat16, seed=7, dev=dev)
    kw = dict(npg=64, epg=256, shift="graph")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gat_round(*args, ins, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        got = gat_round(*args, ins, **kw)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want = gat_round_reference(*f32, ins.float(), **kw)
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **TOL[torch.bfloat16])
    # the launches count where they run: the replays, not the capture
    assert _since(before, GAT) == (2, 0)


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
    before = launch_counts()
    got, counter = _backward_launch(grad, *args, ins, keep, npg=npg, epg=epg,
                                    shift=shift)
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    want = gat_round_backward_reference(
        grad.float(), *f32, None if ins is None else ins.float(), keep,
        npg=npg, epg=epg, shift=shift)
    torch.cuda.synchronize()
    assert _since(before, GAT) == (0, 1)
    names = ("d_xw", "d_alpha_l", "d_alpha_r", "d_alpha_e", "d_ins_value")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None
            continue
        assert torch.isfinite(g).all(), name
        tol = TOL[dtype] if name in ("d_xw", "d_ins_value") else TOL[
            torch.float32]
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=name)
    return got, counter


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
    _, counter = _check_backward(args, ins, _keep(args, 0.1, seed=27), 64,
                                 256, "graph", dtype)
    assert int(counter) == B * 4


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
    every unit out again, and the replays equal an eager call bit for bit
    and count their launches on the card."""
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
    before = launch_counts()
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
    assert _since(before, GAT) == (0, 2)


@pytest.mark.parametrize("B", [1, 7, 133])
def test_backward_graphs_without_edges(B):
    """Graphs without real edges and dummy graphs get exact zeros."""
    dev = _device()
    args, ins = _inputs(64, 256, B, 4, 300, torch.bfloat16, seed=16,
                        dev=dev, dummies=min(2, B - 1))
    args[2][1::5] = 0.0
    got, _ = _check_backward(args, ins, None, 64, 256, "graph",
                             torch.bfloat16)
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

    f0 = launch_counts()
    got = run(gat_round)
    assert _since(f0, GAT) == (1, 1)
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
        f0 = launch_counts()
        _, m = make_train_step(model, cfg)(
            state, batch.to(device), torch.Generator(device=device))
        launched = _since(f0, GAT)
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
        f0 = launch_counts()
        vectors, tokens, _ = make_eval_step(model, cfg)(batch.to(device))
        logits.append(vectors["sa_score"].cpu())
        if device != "cpu":
            assert _since(f0, GAT) == (kernels, 0)
            f0 = launch_counts()
            _, m = make_train_step(model, cfg)(
                create_train_state(model), batch.to(device),
                torch.Generator(device=device).manual_seed(0))
            torch.cuda.synchronize()
            assert torch.isfinite(m["total"])
            assert _since(f0, GAT) == (kernels, kernels)
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["gcn", "gine", "lcgn", "onlysg",
                                    "gat_exec"])
def test_every_family_card_against_cpu(family):
    """Each engine family (and gat with the execution engine) at tiny width
    in float32: the eval logits (and the bitmap) within 1e-4 of the CPU's;
    one train step's loss to rtol 1e-5 and every gradient within 1e-4 of its
    tensor's largest |gradient| + 1e-7; the GAT kernels launch once per
    round on onlysg and gat, never on gcn, gine and lcgn, the GINE pair
    once per round on gine only, and LCGN's linears once each (and its row
    list once a forward) on lcgn only. LCGN's context features are one
    fixed draw on both sides."""
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
    gine = cfg.model.engine.num_rounds if kind == "gine" else 0
    # lcgn: one row list a forward; init_sg_emb_input, proj_x_loc and
    # fin_layer, then proj_x_ctx, lin_l/lin_r/cal_x and output_layer per
    # iteration, each one launch forward and one backward
    lists = int(kind == "lcgn")
    linears = (3 + 3 * cfg.model.engine.lcgn_iters) * lists

    runs = []
    for device in ("cpu", dev):
        model = build_model(cfg.model, device=device, seed=3)
        if kind == "lcgn":
            model.lcgn_seq.forward = functools.partial(
                model.lcgn_seq.forward, x_ctx=noise.to(device))
        f0 = launch_counts()
        out = model.sample(batch.to(device))
        f1 = launch_counts()
        _, m = make_train_step(model, cfg)(
            create_train_state(model, lr=1e-3), batch.to(device),
            torch.Generator(device=device))
        f2 = launch_counts()
        # each pair's forward launches in the request, then its forward and
        # backward launches in the step
        launched = tuple(b[kind] - a[kind] for a, b, kind in (
            (f0, f1, "gat_round"), (f1, f2, "gat_round"),
            (f1, f2, "gat_round_backward"), (f0, f1, "gine_messages"),
            (f1, f2, "gine_messages"), (f1, f2, "gine_messages_backward"),
            (f0, f1, "lcgn_rows"), (f0, f1, "lcgn_linear"),
            (f1, f2, "lcgn_rows"), (f1, f2, "lcgn_linear"),
            (f1, f2, "lcgn_linear_backward")))
        bitmap = out.execution_bitmap
        runs.append((out.short_answer_logits.cpu(),
                     None if bitmap is None else bitmap.cpu(),
                     float(m["total"]), launched,
                     {n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None}))
    (lc, bc, loss_c, launched_c, gc), (lg, bg, loss_g, launched_g, gg) = runs
    assert launched_c == (0,) * 11
    assert launched_g == (rounds, rounds, rounds, gine, gine, gine, lists,
                          linears, lists, linears, linears)
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
        assert tuple(got["launches"][kind] for kind in GAT) == (rounds,
                                                                rounds)
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
    assert [tuple(r["launches"][kind] for kind in GAT)
            for r in (r0, r1)] == [(rounds, rounds)] * 2
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


def test_captured_steps_equal_the_eager_ones():
    """Three train steps with dropout on, replayed as a CUDA graph (eager
    warm-up, capture, replay) against the eager step from the same weights
    and generator seed, under deterministic algorithms: every loss, every
    parameter and running statistic bit for bit, and both kernels counted
    once per round in every step, replays included; then the eval step's
    replay against the eager one, bit for bit."""
    import dataclasses
    from graphvqa_tpu_torch.models.pipeline import build_model
    from graphvqa_tpu_torch.train.loop import make_eval_step, make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    dev = _device()
    cfg, b0 = tiny_train_case(seed=0)
    _, b1 = tiny_train_case(seed=1)
    mc = cfg.model
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        mc, classifier_dropout=0.2,
        transformer=dataclasses.replace(mc.transformer, dropout=0.1),
        engine=dataclasses.replace(mc.engine, dropout=0.1)))
    batches = [b.to(dev) for b in (b0, b1, b0)]
    rounds = cfg.model.engine.num_rounds
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for capture in (True, False):
            model = build_model(cfg.model, device=dev, seed=3)
            state = create_train_state(model, lr=1e-3)
            step = make_train_step(model, cfg, capture=capture)
            gen = torch.Generator(device=dev).manual_seed(4)
            losses = []
            for batch in batches:
                f0 = launch_counts()
                state, m = step(state, batch, gen)
                losses.append(float(m["total"]))
                assert _since(f0, GAT) == (rounds, rounds)
            runs.append((losses, {n: t.detach().clone()
                                  for n, t in model.state_dict().items()},
                         step.graphs))
        (cap_losses, cap_sd, graphs), (eager_losses, eager_sd, none) = runs
        assert none is None
        assert (graphs.warm_ups, graphs.captures, graphs.replays) == (1, 1, 2)
        assert cap_losses == eager_losses
        for n, t in eager_sd.items():
            assert torch.equal(cap_sd[n], t), n
        eval_cap = make_eval_step(model, cfg)
        eval_eager = make_eval_step(model, cfg, capture=False)
        for batch in batches:
            got = eval_cap(batch)
        want = eval_eager(batches[-1])
        assert eval_cap.graphs.replays == 2
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        for k, v in want[0].items():
            assert torch.equal(got[0][k], v), k
    finally:
        torch.use_deterministic_algorithms(False)


def test_captured_edge_step_on_a_one_rank_nccl_group(tmp_path):
    """The edge-sharded train step and eval request on a one-rank NCCL
    group, given to the mesh as its world and edge group with the batches
    sharded at K=1, so that every pmax, row assembly and the step's
    all-reduce is an NCCL call: each key is one graph (no cut), its replay
    issues no dist.all_reduce from Python, and three train steps (warm-up,
    capture, replay) and three requests equal the eager ones bit for bit
    under deterministic algorithms, both kernels counted once per round in
    every step."""
    import torch.distributed as dist
    from graphvqa_tpu_torch.models.pipeline import build_model
    from graphvqa_tpu_torch.parallel.edge_sharded import (
        make_dp_edge_train_step, make_edge_eval_step, prepare_dp_edge_batch)
    from graphvqa_tpu_torch.parallel.mesh import Mesh
    from graphvqa_tpu_torch.train.train_state import create_train_state
    dev = _device()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    all_reduce, calls = dist.all_reduce, []

    def counted(*args, **kwargs):
        calls[-1] += 1
        return all_reduce(*args, **kwargs)

    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.all_reduce = counted
    try:
        group = dist.group.WORLD
        mesh = Mesh(1, 1, 0, world_group=group, edge_group=group)
        cfg, b0 = tiny_train_case(seed=0)
        _, b1 = tiny_train_case(seed=1)
        batches = [b.to(dev) for b in prepare_dp_edge_batch([b0, b1, b0],
                                                            mesh)]
        rounds = cfg.model.engine.num_rounds
        # the forward's MetaLayer assembly and each round's pmax and
        # assembly, the backward's assemblies, the step's all-reduce
        forward = 1 + 2 * rounds
        train = forward + 1 + rounds + 1
        runs = {}
        for capture in (True, False):
            model = build_model(cfg.model, device=dev, seed=3)
            state = create_train_state(model, lr=1e-3)
            step = make_dp_edge_train_step(model, cfg, mesh, capture=capture)
            gen = torch.Generator(device=dev).manual_seed(4)
            losses, reduces = [], []
            for batch in batches:
                f0 = launch_counts()
                calls.append(0)
                state, m = step(state, batch, gen)
                losses.append(float(m["total"]))
                reduces.append(calls[-1])
                assert _since(f0, GAT) == (rounds, rounds)
            evals = make_edge_eval_step(model, cfg, mesh, capture=capture)
            answers = []
            for batch in batches:
                calls.append(0)
                answers.append(evals(batch))
                reduces.append(calls[-1])
            runs[capture] = (losses, reduces, answers, step.graphs,
                             evals.graphs,
                             {n: t.detach().clone()
                              for n, t in model.state_dict().items()})
        cap, eager = runs[True], runs[False]
        assert eager[3] is None and eager[4] is None
        assert eager[1] == [train] * 3 + [forward] * 3
        # the warm-up and the capture issue the collectives, the replay none
        assert cap[1] == [train, train, 0, forward, forward, 0]
        for graphs in cap[3:5]:
            assert (graphs.warm_ups, graphs.captures, graphs.replays,
                    list(graphs.segments.values())) == (1, 1, 2, [1])
        assert cap[0] == eager[0]
        for n, t in eager[5].items():
            assert torch.equal(cap[5][n], t), n
        for got, want in zip(cap[2], eager[2]):
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[2], want[2])
            for k, v in want[0].items():
                assert torch.equal(got[0][k], v), k
    finally:
        dist.all_reduce = all_reduce
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()


def _gqa_batch(cfg, B, seed):
    """B GQA-shaped random scene graphs (~17 nodes, ~90 edges) at the main
    rung (64, 256) and random token streams of the configured lengths."""
    from graphvqa_tpu_torch.core.graph import QABatch
    rng = np.random.default_rng(seed)
    mc, bc = cfg.model, cfg.batch
    samples = []
    for _ in range(B):
        n = int(np.clip(rng.normal(17, 6), 2, 60))
        e = int(np.clip(n + rng.normal(90, 25), n, 250))
        samples.append(GraphSample(
            node_tokens=rng.integers(2, mc.scene.vocab_size,
                                     (n, 12)).astype(np.int32),
            edge_src=rng.integers(0, n, e).astype(np.int32),
            edge_dst=rng.integers(0, n, e).astype(np.int32),
            edge_tokens=rng.integers(2, mc.scene.vocab_size,
                                     (e, 1)).astype(np.int32),
            edge_sym=rng.random(e) > 0.7))
    graphs = pack_graphs_dense(samples, 64, 256,
                               max_steps=mc.max_execution_steps)

    def tokens(rows, length):
        t = rng.integers(4, mc.text.vocab_size, (rows, length))
        t[:, 0] = mc.text.sos_idx
        return torch.from_numpy(t.astype(np.int32))

    return QABatch(graphs, tokens(B, bc.question_len),
                   tokens(B * mc.max_execution_steps, bc.program_len),
                   tokens(B, bc.full_answer_len),
                   torch.from_numpy(rng.integers(0, mc.num_answers, B)
                                    .astype(np.int32)))


def _profiled_replays(step, state, batch, gen, n):
    """``n`` replays of the train step under torch.profiler -> (the
    device's busy seconds, its operations merged, host spans' mirrors left
    out; the seconds from its first operation's start to its last one's
    end; (start seconds, name) of each operation in start order)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(state, batch, gen)
        torch.cuda.synchronize()
    ops = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                 for ev in prof.events() if ev.device_type == DeviceType.CUDA
                 and not getattr(ev, "is_user_annotation", False)
                 and not ev.name.startswith("gvqa."))
    busy, end = 0.0, None
    for s, e, _ in ops:
        if end is None or s > end:
            busy, end = busy + (e - s), e
        elif e > end:
            busy, end = busy + (e - end), e
    return (busy / 1e6, (end - ops[0][0]) / 1e6,
            [(s / 1e6, e / 1e6, name) for s, e, name in ops])


def test_segment_stamps_in_the_replayed_train_step():
    """gat_config()'s train step at B=64, replayed: captured with tracing
    off it launches no stamp kernel; captured with tracing on, each replay
    runs a begin and six stamps. Each segment, as the card's clock summed
    it, is the time between its stamp and the one before as the profiler
    times the stamp kernels (to 1 % + 10 us over 5 replays); the segments
    cover at least 85 % of the device's busy time over the same replays
    (the rest: the batch copied into the graph's static inputs) and at most
    the replays' elapsed time on the card (they also hold the gaps between
    a replay's kernels). The stamp kernels take under 0.5 % of the busy
    time."""
    from graphvqa_tpu_torch.config import gat_config
    from graphvqa_tpu_torch.core import profiling
    from graphvqa_tpu_torch.models.pipeline import build_model
    from graphvqa_tpu_torch.train.loop import make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    dev = _device()
    cfg = gat_config()
    model = build_model(cfg.model, device=dev, seed=0)
    state = create_train_state(model)
    step = make_train_step(model, cfg)
    batch = _gqa_batch(cfg, 64, seed=5).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    order = ("encoders", "program_decoder", "engine", "classifier",
             "loss_backward", "optimizer")
    try:
        for _ in range(2):          # the warm-up, the capture
            step(state, batch, gen)
        *_, ops = _profiled_replays(step, state, batch, gen, 3)
        assert ops and not any("segment_stamp" in name for *_, name in ops)
        profiling.enable(True)
        for _ in range(2):          # dropped: warmed up and captured again
            step(state, batch, gen)
        assert step.graphs.warm_ups == 2 and step.graphs.captures == 2
        profiling.reset_segments()
        busy, elapsed, ops = _profiled_replays(step, state, batch, gen, 5)
        steps, seconds = profiling.read_segments()
    finally:
        profiling.enable(False)
    assert steps == 5
    stamps = [t for t, _, name in ops if "segment_stamp" in name]
    stamp_s = sum(e - t for t, e, name in ops if "segment_stamp" in name)
    assert len(stamps) == 5 * (1 + len(order))
    assert {k for k, s in seconds.items() if s > 0} == set(order)
    for k, name in enumerate(order):
        want = sum(stamps[7 * r + k + 1] - stamps[7 * r + k]
                   for r in range(5))
        assert abs(seconds[name] - want) <= 0.01 * want + 10e-6, name
    total = sum(seconds.values())
    print(f"segments {', '.join(f'{k} {1e3 * seconds[k] / 5:.3f}' for k in order)} "
          f"ms per step; busy {1e3 * busy / 5:.3f}, elapsed "
          f"{1e3 * elapsed / 5:.3f} ms per step; cover {100 * total / busy:.2f} %; "
          f"stamps {1e6 * stamp_s / 5:.2f} us per step")
    assert 0.85 * busy <= total <= elapsed
    assert stamp_s <= 0.005 * busy


# --- the Transformer stacks' LayerNorm kernels --------------------------------
#
# Held to the plain twin (the composite) on the card. The forward: the
# kernel's statistics against float64 ones and y against the composite's,
# within torch_port_fixtures.LAYER_NORM_ULPS (layer_norm_errors, which says
# why one ulp of y cannot hold; each case prints its readings beside the
# composite's own), and y the composite's formula at the kernel's own
# statistics bit for bit. dx within 1e-5 (f32; bf16 one step) relative plus
# 2e-6 of its largest element, dweight and dbias within 1e-5 of the sums of
# the terms' magnitudes (the same float32 terms over up to 16,000 rows in
# another order), against autograd through the composite.

LN_ROWS = [1, 200, 1000, 6400, 16000]
LN_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
            (torch.float32, torch.bfloat16)]


def _ln_inputs(kind, rows, d, x_dtype, seed, dev):
    gen = torch.Generator().manual_seed(seed + 1)
    w = torch.randn(d, generator=gen) * 0.5 + 1.0
    b = torch.randn(d, generator=gen) * 0.1
    x = layer_norm_rows(kind, rows, d, seed).to(x_dtype)
    return x.to(dev), w.to(dev), b.to(dev)


def _ln_both(x, w, b, y_dtype, dy):
    """(kernel, composite) runs: each (y, dx, dweight, dbias, stats or
    None), the composite through autograd on the card."""
    out = []
    for fn in (rln.layer_norm, rln.layer_norm_reference):
        xx, ww, bb = (t.detach().clone().requires_grad_() for t in (x, w, b))
        y = fn(xx, ww, bb, 1e-5, y_dtype)
        y.backward(dy)
        out.append((y.detach(), xx.grad, ww.grad, bb.grad))
    torch.cuda.synchronize()
    return out


def _ln_formula(x, w, b, y_dtype, stats):
    """The composite's forward formula on the card with given statistics."""
    mean, rstd = stats[:, :1], stats[:, 1:].abs()
    xf = x.float().reshape(-1, x.shape[-1])
    return ((xf - mean) * (rstd * w) + b).to(y_dtype).reshape(x.shape)


def _bf16_step(got, want):
    """One bfloat16 step at the larger magnitude of each pair."""
    big = torch.maximum(got.float().abs(), want.float().abs())
    _, exp = torch.frexp(big)
    return torch.ldexp(torch.ones_like(big), exp - 8)


def _ln_check_forward(y, y_ref, x, w, b, stats):
    got = layer_norm_errors(x, w, b, stats, y, y_ref)
    own = layer_norm_errors(x, w, b, layer_norm_stats(x), y_ref, y_ref)
    print(f"layer_norm {tuple(x.shape)} {x.dtype} -> {y.dtype}: kernel "
          f"mean {got[0]:.2f}, rstd {got[1]:.2f}, y {got[2]:.2f} ulps; the "
          f"composite's statistics mean {own[0]:.2f}, rstd {own[1]:.2f}")
    keys = ("mean", "rstd", "y." + str(y.dtype)[6:])
    for key, reading in zip(keys, got):
        assert reading <= LAYER_NORM_ULPS[key], (key, reading)
    assert torch.equal(y, _ln_formula(x, w, b, y.dtype, stats))


def _ln_check_backward(got, want, x, dy, stats):
    _, dx, dw, db = got
    _, dx_ref, dw_ref, db_ref = want
    scale = dx_ref.float().abs().max().item()
    if dx.dtype == torch.bfloat16:
        assert bool(((dx.float() - dx_ref.float()).abs()
                     <= _bf16_step(dx, dx_ref) + 2e-6 * scale).all())
    else:
        torch.testing.assert_close(dx, dx_ref, rtol=1e-5, atol=2e-6 * scale)
    d = x.shape[-1]
    xhat = ((x.float().reshape(-1, d) - stats[:, :1]) * stats[:, 1:].abs())
    dyf = dy.float().reshape(-1, d)
    for g, r, mag in ((dw, dw_ref, (dyf * xhat).abs().sum(0)),
                      (db, db_ref, dyf.abs().sum(0))):
        assert g.dtype == torch.float32
        assert bool(((g - r).abs() <= 1e-5 * mag + 1e-30).all())


def _ln_case(kind, rows, d, x_dtype, y_dtype, seed):
    dev = _device()
    x, w, b = _ln_inputs(kind, rows, d, x_dtype, seed, dev)
    dy = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(seed))
    dy = dy.to(y_dtype)
    f0 = launch_counts()
    got, want = _ln_both(x, w, b, y_dtype, dy)
    assert _since(f0, LN) == (1, 1)
    _, stats = rln.layer_norm_forward(x, w, b, 1e-5, y_dtype, keep_stats=True)
    assert got[0].dtype == y_dtype and got[1].dtype == x_dtype
    _ln_check_forward(got[0], want[0], x, w, b, stats)
    _ln_check_backward(got, want, x, dy, stats)
    return x, stats


@pytest.mark.parametrize("x_dtype,y_dtype", LN_PAIRS)
@pytest.mark.parametrize("rows", LN_ROWS)
def test_layer_norm_kernels_main_width(rows, x_dtype, y_dtype):
    """D = 512, every row count the stacks meet (and 1): the forward, the
    backward through autograd, one launch of each."""
    _ln_case("random", rows, 512, x_dtype, y_dtype, seed=rows)


@pytest.mark.parametrize("x_dtype,y_dtype", LN_PAIRS)
@pytest.mark.parametrize("rows,d", [(6400, 300), (1000, 1024), (200, 64),
                                    (33, 7)])
def test_layer_norm_kernels_other_widths(rows, d, x_dtype, y_dtype):
    """Widths that take the one-element loads (300 in bf16, 7), the 32
    elements a lane (1024) and the tiny model's 64."""
    _ln_case("random", rows, d, x_dtype, y_dtype, seed=d)


@pytest.mark.parametrize("x_dtype,y_dtype", LN_PAIRS)
def test_layer_norm_constant_and_zero_rows(x_dtype, y_dtype):
    """Constant rows (in float32 x many round E[x^2] - E[x]^2 below 0, and
    the kernel marks them clamped) and all-zero rows (y = bias exactly):
    the output is the formula at the kernel's statistics bit for bit, the
    mean is the row's value, and the backward is the closed form at the
    kernel's statistics, clamped rows passing no gradient through the
    variance."""
    dev = _device()
    d = 512
    x = torch.cat([layer_norm_rows("constant", 256, d, seed=9),
                   layer_norm_rows("zero", 16, d)]).to(x_dtype).to(dev)
    w, b = _ln_inputs("zero", 1, d, torch.float32, 10, dev)[1:]
    y, stats = rln.layer_norm_forward(x, w, b, 1e-5, y_dtype, keep_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(y, _ln_formula(x, w, b, y_dtype, stats))
    assert torch.equal(y[256:], b.to(y_dtype).expand(16, d))
    torch.testing.assert_close(stats[:, 0], x[:, 0].float(), rtol=1e-6,
                               atol=0)
    clamped = stats[:, 1] < 0
    if x_dtype == torch.float32:
        assert bool(clamped.any()) and not bool(clamped.all())
    else:
        assert not bool(clamped.any())   # exact sums: the variance is 0
    dy = torch.randn(x.shape, device=dev).to(y_dtype)
    dx, dw, db = rln.layer_norm_backward(dy, x, w, stats)
    g = dy.float() * w
    mg = g.mean(dim=-1, keepdim=True)
    xhat = (x.float() - stats[:, :1]) * stats[:, 1:].abs()
    mgx = torch.where(clamped[:, None], 0.0,
                      (g * xhat).mean(dim=-1, keepdim=True))
    want = stats[:, 1:].abs() * (g - mg - xhat * mgx)
    scale = want.abs().max().item()
    torch.testing.assert_close(dx.float(), want.to(x_dtype).float(),
                               rtol=2.0 ** -7 if x_dtype == torch.bfloat16
                               else 1e-5, atol=2e-6 * scale)
    torch.testing.assert_close(db, dy.float().sum(0), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dw, (dy.float() * xhat).sum(0), rtol=1e-5,
                               atol=1e-4)


def test_layer_norm_replays_in_a_cuda_graph():
    """Forward and backward captured once (autograd through the kernels)
    and replayed on new rows: each replay equals the eager calls bit for
    bit, and counts one launch of each kernel; the capture counts none."""
    dev = _device()
    x, w, b = _ln_inputs("random", 1000, 512, torch.bfloat16, 11, dev)
    x = x.requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    dy = torch.randn(1000, 512, device=dev).bfloat16()

    def run():
        for t in (x, w, b):
            t.grad = None
        y = rln.layer_norm(x, w, b, 1e-5, torch.bfloat16)
        y.backward(dy)
        return y

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        y = run()
    torch.cuda.synchronize()
    assert _since(before, LN) == (0, 0)
    grads = (x.grad, w.grad, b.grad)
    for seed in (12, 13):
        with torch.no_grad():
            x.copy_(_ln_inputs("random", 1000, 512, torch.bfloat16, seed,
                               dev)[0])
        graph.replay()
        torch.cuda.synchronize()
        ref_y, ref_dx, ref_dw, ref_db = _ln_both(
            x.detach(), w.detach(), b.detach(), torch.bfloat16, dy)[0]
        assert torch.equal(y, ref_y)
        for got, ref in zip(grads, (ref_dx, ref_dw, ref_db)):
            assert torch.equal(got, ref)
    # two replays plus the two eager comparisons
    assert _since(before, LN) == (4, 4)


def test_layer_norm_backward_runs_agree_bit_for_bit():
    dev = _device()
    x, w, b = _ln_inputs("random", 16000, 512, torch.bfloat16, 14, dev)
    _, stats = rln.layer_norm_forward(x, w, b, 1e-5, torch.bfloat16,
                                      keep_stats=True)
    dy = torch.randn(16000, 512, device=dev).bfloat16()
    first = rln.layer_norm_backward(dy, x, w, stats)
    second = rln.layer_norm_backward(dy, x, w, stats)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_layer_norm_launches_per_step_under_replay(monkeypatch):
    """gat_config()'s train step and eval request at B=64, replayed as CUDA
    graphs: every replay launches the LayerNorm kernels as often as the
    eager warm-up called the module, forward 27 a train step (7 in the
    question encoder, 10 in the coarse and 10 in the teacher-forced program
    decoder) and 357 an eval request (7 + 10 + 15 greedy steps x 10 + 19 x
    10), backward 17 a train step: the teacher-forced decoder's logits
    reach no loss while the program loss is off (gat_config()), so autograd
    runs no backward through its 10; and the composite never runs on the
    card."""
    from graphvqa_tpu_torch.config import gat_config
    from graphvqa_tpu_torch.models.pipeline import build_model
    from graphvqa_tpu_torch.nn.transformer import LayerNorm
    from graphvqa_tpu_torch.train.loop import make_eval_step, make_train_step
    from graphvqa_tpu_torch.train.train_state import create_train_state
    dev = _device()

    def refuse(*args, **kwargs):
        raise AssertionError("the plain LayerNorm ran on the card")

    monkeypatch.setattr(rln, "layer_norm_reference", refuse)
    cfg = gat_config()
    model = build_model(cfg.model, device=dev, seed=0)
    state = create_train_state(model)
    batch = _gqa_batch(cfg, 64, seed=15).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = []
    hooks = [m.register_forward_hook(lambda *a: calls.append(1))
             for m in model.modules() if isinstance(m, LayerNorm)]
    train_step = make_train_step(model, cfg)
    eval_step = make_eval_step(model, cfg)
    train_step(state, batch, gen)            # the eager warm-ups
    train_calls = len(calls)
    eval_step(batch)
    eval_calls = len(calls) - train_calls
    for h in hooks:
        h.remove()
    assert (train_calls, eval_calls) == (27, 357)
    assert not cfg.train.use_program_loss
    train_backward = train_calls - 10
    train_step(state, batch, gen)            # the captures
    eval_step(batch)
    for _ in range(2):
        f0 = launch_counts()
        train_step(state, batch, gen)
        torch.cuda.synchronize()
        assert _since(f0, LN) == (train_calls, train_backward)
        f0 = launch_counts()
        eval_step(batch)
        torch.cuda.synchronize()
        assert _since(f0, LN) == (eval_calls, 0)
    assert train_step.graphs.replays == 3 and eval_step.graphs.replays == 3


# --- the GINE round's messages and sum (ops/gine_messages.py) ----------------

GINE_C, GINE_D = 300, 512
# (h, edge_attr, ins) dtypes: the bf16 model's rounds after the first, its
# first round (the scene encoder's float32 h) and the float32 configurations
GINE_DTYPES = {"bfloat16": (torch.bfloat16,) * 3,
               "first_round": (torch.float32, torch.bfloat16, torch.bfloat16),
               "float32": (torch.float32,) * 3}


def _gine_inputs(g, dtypes, seed, dev, C=GINE_C, D=GINE_D):
    """The pair's inputs on a packed batch ``g`` (ins already in the
    messages' dtype, as the backward takes it) and a dz."""
    g = g.to(dev)
    dl, sl = dense_local_indices(g)
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    th, te, ti = dtypes
    h, edge_attr = randn(g.nodes_pad, C).to(th), randn(g.edges_pad, C).to(te)
    ins = randn(g.num_graphs, D).to(ti)
    ins = ins.to(gm.messages_dtype(h, ins, edge_attr))
    dz = randn(g.nodes_pad, C + D).to(ins.dtype)
    return (h, ins, edge_attr, dl, sl, g.edge_mask.reshape(dl.shape)), dz


def _gine_close(got, want):
    """bf16: within 2^-7 of the tensor's largest |value| (two bf16 ulps:
    the f32 sums' order differs, then the sum and z or dh round once each);
    float32: TOL."""
    assert got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -7 * float(want.float().abs().max()), err
    else:
        torch.testing.assert_close(got, want, **TOL[torch.float32])


def _gine_check(args, dz, npg):
    """The pair against the plain versions run on the card: z's ins half
    and d_edge_attr bit for bit, the rest within _gine_close; one launch of
    each counted on the card."""
    C = args[0].shape[1]
    f0 = launch_counts()
    z = gm.gine_messages(*args, npg=npg)
    grads = gm.gine_messages_backward(dz, *args, npg=npg)
    torch.cuda.synchronize()
    assert _since(f0, GINE) == (1, 1)
    z_ref = gm.gine_messages_reference(*args, npg=npg)
    g_ref = gm.gine_messages_backward_reference(dz, *args, npg=npg)
    assert torch.isfinite(z.float()).all()
    assert torch.equal(z[:, C:], z_ref[:, C:])
    _gine_close(z, z_ref)
    assert torch.equal(grads[1], g_ref[1])
    _gine_close(grads[0], g_ref[0])
    _gine_close(grads[2], g_ref[2])
    return z, grads


@pytest.mark.parametrize("dtypes", sorted(GINE_DTYPES))
def test_gine_pair_every_ladder_rung(dtypes):
    """Every (npg, epg) rung the collate can produce, up to (512, 2048),
    at C=300, D=512: a graph that fills the rung, ragged ones and a dummy
    graph (the top rungs' stages need the opted-in shared memory)."""
    dev = _device()
    for npg, epg in LADDER:
        args, dz = _gine_inputs(_rung_graphs(npg, epg, seed=npg + epg),
                                GINE_DTYPES[dtypes], seed=npg, dev=dev)
        _gine_check(args, dz, npg)


@pytest.mark.parametrize("dtypes", sorted(GINE_DTYPES))
def test_gine_pair_main_shape_twice_bit_for_bit(dtypes):
    """B=200 GQA-shaped graphs at (64, 256): against the plain versions,
    and two runs of each kernel bit for bit."""
    dev = _device()
    from graphvqa_tpu_torch.config import gine_config
    g = _gqa_batch(gine_config(), 200, seed=22).graphs
    args, dz = _gine_inputs(g, GINE_DTYPES[dtypes], seed=3, dev=dev)
    z, grads = _gine_check(args, dz, 64)
    assert torch.equal(gm.gine_messages(*args, npg=64), z)
    again = gm.gine_messages_backward(dz, *args, npg=64)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


@pytest.mark.parametrize("case", ["no_edges", "all_masked"])
def test_gine_pair_graphs_without_real_edges(case):
    """Graphs without edges, and a batch whose every edge is masked while
    its indices still point at real nodes: z is [h ; ins], dh dz's first
    columns, d_edge_attr 0."""
    dev = _device()
    if case == "no_edges":
        samples = [GraphSample(
            node_tokens=np.ones((n, 12), np.int32),
            edge_src=np.zeros(0, np.int32), edge_dst=np.zeros(0, np.int32),
            edge_tokens=np.ones((0, 1), np.int32),
            edge_sym=np.zeros(0, bool)) for n in (1, 30, 64)]
        g = pack_graphs_dense(samples, 64, 256, num_graphs=4)
    else:
        g = _rung_graphs(64, 256, seed=4)
        g.edge_mask[:] = False
    args, dz = _gine_inputs(g, GINE_DTYPES["float32"], seed=5, dev=dev)
    z, (dh, d_edge, _) = _gine_check(args, dz, 64)
    h, ins = args[0], args[1]
    assert torch.equal(z, torch.cat([h, ins.repeat_interleave(64, 0)], -1))
    assert torch.equal(dh, dz[:, :GINE_C]) and not bool(d_edge.any())


@pytest.mark.parametrize("dtypes", ["bfloat16", "float32"])
@pytest.mark.parametrize("widths", [(300, 512), (13, 7)])
def test_gine_pair_unaligned_inputs_and_odd_widths(widths, dtypes):
    """h, edge_attr, ins and dz one element past an aligned address, and
    widths that are not a multiple of 4: the one-element loads."""
    dev = _device()
    C, D = widths
    args, dz = _gine_inputs(_rung_graphs(64, 256, seed=6),
                            GINE_DTYPES[dtypes], seed=7, dev=dev, C=C, D=D)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    h, ins, edge_attr = (shifted(t) for t in args[:3])
    dz = shifted(dz)
    assert h.data_ptr() % 8 and edge_attr.data_ptr() % 8
    _gine_check((h, ins, edge_attr) + args[3:], dz, 64)


def test_gine_pair_replays_in_a_cuda_graph():
    """Forward and backward captured once and replayed twice, at the main
    rung and the top one (whose attribute the eager launch set): the
    replays give the eager bits and count their launches, the capture
    none."""
    dev = _device()
    for npg, epg in ((64, 256), (512, 2048)):
        args, dz = _gine_inputs(_rung_graphs(npg, epg, seed=8),
                                GINE_DTYPES["bfloat16"], seed=9, dev=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            z_eager = gm.gine_messages(*args, npg=npg)
            g_eager = gm.gine_messages_backward(dz, *args, npg=npg)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph):
            z = gm.gine_messages(*args, npg=npg)
            grads = gm.gine_messages_backward(dz, *args, npg=npg)
        for _ in range(2):
            for t in (z,) + grads:
                t.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(z, z_eager)
            assert all(torch.equal(a, b) for a, b in zip(grads, g_eager))
        assert _since(before, GINE) == (2, 2)


@pytest.mark.parametrize("dtypes", sorted(GINE_DTYPES))
def test_gine_pair_through_autograd(dtypes):
    """gine_messages with leaves that need gradients: the backward kernel
    gives the plain backward's gradients, ins's in its own dtype (the
    first round's bf16 ins goes through the float32 messages), one launch
    of each kernel."""
    dev = _device()
    args, dz = _gine_inputs(_rung_graphs(64, 256, seed=10),
                            GINE_DTYPES[dtypes], seed=11, dev=dev)
    ins = args[1].to(GINE_DTYPES[dtypes][2])
    leaves = [t.clone().requires_grad_() for t in (args[0], ins, args[2])]
    f0 = launch_counts()
    z = gm.gine_messages(*leaves, *args[3:], npg=64)
    dh, d_ins, d_edge = torch.autograd.grad(z, leaves, dz)
    torch.cuda.synchronize()
    assert _since(f0, GINE) == (1, 1)
    want = gm.gine_messages_backward_reference(dz, *args, npg=64)
    assert d_ins.dtype == ins.dtype
    _gine_close(dh, want[0])
    assert torch.equal(d_edge, want[1])
    _gine_close(d_ins, want[2].to(ins.dtype))


def test_gine_kernel_stops_on_unsorted_edges():
    """Real edges out of destination order trip the forward's device
    assert (which ends the CUDA context: a subprocess)."""
    _device()
    script = textwrap.dedent("""
        import torch
        from graphvqa_tpu_torch.ops.gine_messages import gine_messages
        dev = torch.device("cuda")
        dl = torch.tensor([[1, 0, 0, 0]], dtype=torch.int32, device=dev)
        sl = torch.zeros(1, 4, dtype=torch.int32, device=dev)
        mask = torch.tensor([[True, True, False, False]], device=dev)
        z = lambda *s: torch.zeros(*s, device=dev)
        gine_messages(z(2, 4), z(1, 4), z(4, 4), dl, sl, mask, npg=2)
        torch.cuda.synchronize()
        print("no assert")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300,
                          cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode != 0, proc.stdout
    assert "assert" in proc.stderr.lower(), proc.stderr[-2000:]


# --- LCGN's node-wise float32 linears (ops/lcgn_linear.py) -------------------

LCGN = ("lcgn_rows", "lcgn_linear", "lcgn_linear_backward")
# (rows, in features, out features) at the lcgn cell's shapes: B=200 at
# npg 64 and 128; init_sg_emb_input, proj_x_{loc,ctx}, output_layer and
# fin_layer, and lin_l / lin_r / cal_x stacked (1,536 -> 1,536)
LCGN_SHAPES = [(200 * npg, k, n) for npg in (64, 128)
               for k, n in ((300, 512), (512, 512), (1024, 512), (1536, 512),
                            (1536, 1536))]


def _lcgn_inputs(mask, K, Nout, bias, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    N = mask.shape[0]
    return (randn(N, K), randn(Nout, K) / K ** 0.5,
            randn(Nout) if bias else None, randn(N, Nout))


def _within_round_off(got, want, n, scale):
    """Within the float32 round-off bound of two sums of n terms
    (torch_port_fixtures.round_off_share)."""
    share = round_off_share(got, want, n, scale)
    assert share <= 1.0, share


def _lcgn_check(mask, K, Nout, bias, seed, dev):
    """The pair against the plain versions run on the card (TF32 off): y,
    dx, dW and db within _within_round_off, the padding rows of y and dx
    exactly 0, one launch of each kernel; a second run bit for bit."""
    from graphvqa_tpu_torch.ops import lcgn_linear as ll
    assert not torch.backends.cuda.matmul.allow_tf32
    mask = mask.to(dev)
    x, w, b, dy = _lcgn_inputs(mask, K, Nout, bias, seed, dev)
    runs = []
    for _ in range(2):
        f0 = launch_counts()
        rows = ll.node_rows(mask)
        y = ll.lcgn_linear(x, w, b, rows)
        grads = ll.lcgn_linear_backward(dy, x, w, rows.perm, rows.count,
                                        has_bias=bias)
        torch.cuda.synchronize()
        assert _since(f0, LCGN) == (1, 1, 1)
        runs.append((rows.perm, rows.count, y) + grads)
    for a, c in zip(*runs):
        assert (a is None and c is None) or torch.equal(a, c)
    perm, count = ll.node_rows_reference(mask)
    assert torch.equal(runs[0][0], perm) and torch.equal(runs[0][1], count)
    y, dx, dw, db = runs[0][2:]
    y_ref = ll.lcgn_linear_reference(x, w, b, mask)
    ref = ll.lcgn_linear_backward_reference(dy, x, w, mask, has_bias=bias)
    m = mask[:, None]
    ax, aw = torch.where(m, x, 0.0).abs(), w.abs()
    ady = torch.where(m, dy, 0.0).abs()
    real = int(count)
    _within_round_off(y, y_ref, K + 1, ax @ aw.t() + (
        b.abs() if bias else 0.0))
    _within_round_off(dx, ref[0], Nout, ady @ aw)
    _within_round_off(dw, ref[1], real, ady.t() @ ax)
    if bias:
        _within_round_off(db, ref[2], real, ady.sum(0))
    else:
        assert db is None
    assert not y[~mask].any() and not dx[~mask].any()


@pytest.mark.parametrize("N,K,Nout", LCGN_SHAPES)
def test_lcgn_linear_pair_at_the_cell_shapes(N, K, Nout):
    """The lcgn cell's shapes on a mask drawn from the traffic's scene law
    (about 28 % real rows at npg 64, 14 % at 128)."""
    dev = _device()
    npg = N // 200
    _lcgn_check(scene_law_mask(200, npg, seed=N + K), K, Nout,
                bias=Nout == 512, seed=K, dev=dev)


@pytest.mark.parametrize("case", ["all_real", "none_real", "one_full_block",
                                  "odd_widths"])
def test_lcgn_linear_pair_edge_cases(case):
    """Every row real, no row real, one graph that fills its block among
    dummy graphs (the flat layout's and the dense layout's masks are both
    a row mask), and widths that take the one-float pieces (13 -> 7)."""
    dev = _device()
    N = 64 * 37
    K, Nout = (13, 7) if case == "odd_widths" else (512, 512)
    mask = {"all_real": torch.ones(N, dtype=torch.bool),
            "none_real": torch.zeros(N, dtype=torch.bool),
            "one_full_block": torch.arange(N) < 64,
            "odd_widths": scene_law_mask(37, 64, seed=5)}[case]
    _lcgn_check(mask, K, Nout, bias=True, seed=3, dev=dev)


def test_lcgn_linear_pair_unaligned_rows():
    """x and dy as views that start 4 bytes into their storage: the
    kernels take the one-float pieces and give the same values."""
    from graphvqa_tpu_torch.ops import lcgn_linear as ll
    dev = _device()
    mask = scene_law_mask(50, 64, seed=6).to(dev)
    x, w, b, dy = _lcgn_inputs(mask, 512, 512, True, 7, dev)
    xs = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x).copy_(x)
    dys = torch.empty(dy.numel() + 1, device=dev)[1:].view_as(dy).copy_(dy)
    assert xs.data_ptr() % 16 and dys.data_ptr() % 16
    rows = ll.node_rows(mask)
    y = ll.lcgn_linear(x, w, b, rows)
    ys = ll.lcgn_linear(xs, w, b, rows)
    grads = ll.lcgn_linear_backward(dy, x, w, rows.perm, rows.count)
    grads_s = ll.lcgn_linear_backward(dys, xs, w, rows.perm, rows.count)
    torch.testing.assert_close(ys, y, rtol=0, atol=0)
    for a, c in zip(grads_s, grads):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_lcgn_linear_pair_through_autograd_and_a_cuda_graph():
    """lcgn_linear on leaves that need gradients: the backward kernel's
    gradients, x's only where it needs one; then the row list, forward and
    backward captured once and replayed twice (the attribute set by the
    eager launches): the eager bits, launches counted by the replays."""
    from graphvqa_tpu_torch.ops import lcgn_linear as ll
    dev = _device()
    mask = scene_law_mask(200, 64, seed=8).to(dev)
    x, w, b, dy = _lcgn_inputs(mask, 1024, 512, True, 9, dev)
    rows = ll.node_rows(mask)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    f0 = launch_counts()
    got = torch.autograd.grad(ll.lcgn_linear(*leaves, rows), leaves, dy)
    frozen = torch.autograd.grad(ll.lcgn_linear(x, *leaves[1:], rows),
                                 leaves[1:], dy)
    torch.cuda.synchronize()
    assert _since(f0, LCGN) == (0, 2, 2)
    want = ll.lcgn_linear_backward(dy, x, w, rows.perm, rows.count)
    for a, c in zip(got, want):
        assert torch.equal(a, c)
    assert all(torch.equal(a, c) for a, c in zip(frozen, want[1:]))

    def body():
        r = ll.node_rows(mask)
        return (ll.lcgn_linear(x, w, b, r),) + ll.lcgn_linear_backward(
            dy, x, w, r.perm, r.count)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        out = body()
    for _ in range(2):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(out, eager))
    assert _since(before, LCGN) == (2, 2, 2)
