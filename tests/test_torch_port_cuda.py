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

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2.0 ** -8, atol=1e-5)}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


def _inputs(npg, epg, B, H, C, dtype, seed, dev):
    """Ragged graphs with parallel edges, self-loops, a node without
    in-edges per graph and fully padded dummy graphs at the end."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(B - 2):
        n = int(rng.integers(2, npg + 1))
        e = int(rng.integers(2, epg + 1))
        src = rng.integers(0, n, size=e).astype(np.int32)
        dst = rng.integers(0, n - 1, size=e).astype(np.int32)
        src[1], dst[1] = src[0], dst[0]
        samples.append(GraphSample(
            node_tokens=np.ones((n, 12), np.int32), edge_src=src,
            edge_dst=dst, edge_tokens=np.ones((e, 1), np.int32),
            edge_sym=np.zeros(e, bool)))
    g = pack_graphs_dense(samples, npg, epg, num_graphs=B).to(dev)
    dl, sl = dense_local_indices(g)
    mask = g.edge_mask.reshape(B, epg).float()
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    N = B * npg
    return (dl, sl, mask, randn(N, H), randn(N, H), randn(B, epg, H),
            randn(N, H, C).to(dtype)), randn(B, H, C).to(dtype)


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
