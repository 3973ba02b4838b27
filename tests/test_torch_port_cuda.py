"""The GAT-round CUDA kernel against its plain PyTorch twin, on the card.

Needs an NVIDIA GPU and nvcc; skips without them. Imports no JAX, so it runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

The kernel is held to the plain version's float32 result on the same input
values. Tolerances: f32 rtol/atol 1e-4 (the same f32 sums in another order);
bf16 rtol 2^-8 and atol 1e-5: the kernel accumulates in f32 and rounds its
output once, so half a bf16 ulp plus the f32 reordering is all it may lose.
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
from graphvqa_tpu_torch.ops.gat_round import gat_round, gat_round_reference
# a top-level import: pytest puts tests/ on sys.path, and the card's machine
# may have another package named `tests`
from torch_port_fixtures import tiny_gat_seq

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
    """B graphs of exactly n nodes whose edges reach the last node, so each
    graph's staged xw rows are n full rows."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(B):
        e = int(rng.integers(n, epg + 1))
        src = rng.integers(0, n, size=e).astype(np.int32)
        dst = rng.integers(0, n, size=e).astype(np.int32)
        src[0] = n - 1
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
