"""LCGN's node-wise float32 linears over the real node rows
(``ops/lcgn_linear.py``) on the CPU, where the wrapper runs the plain
versions: the forward against ``F.linear``, the backward's closed form
against autograd through the masked product, the row list's plain twin, and
the LCGN engine against the same engine computing every padded row.

Tolerances. The forward's real rows are ``F.linear``'s own values (the same
call), so they are compared bit for bit. The backward's closed form is the
same float32 products as autograd's in another grouping: rtol/atol 1e-5.
The engine against its every-row twin: padded rows enter no real row's
value or gradient, and a padded row's product adds exact zeros to the
weight gradients, so the two agree to float32 round-off of the sums'
order: rtol 1e-5, atol 1e-6 of each tensor's largest value.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graphvqa_tpu_torch.core.packing import (
    GraphSample, pack_graphs, pack_graphs_dense)
from graphvqa_tpu_torch.nn import gnn
from graphvqa_tpu_torch.ops import lcgn_linear as ll


def samples(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [GraphSample(
        np.ones((n, 12), np.int32), rng.integers(0, n, e).astype(np.int32),
        rng.integers(0, n, e).astype(np.int32), np.ones((e, 1), np.int32),
        np.zeros(e, bool)) for n, e in sizes]


# a graph that fills its block, ragged ones, one with a single node and no
# edges, and in the dense layout (num_graphs one more) a graph with no real
# rows at all
SIZES = ((8, 20), (3, 5), (5, 9), (1, 0))


def graph(layout):
    if layout == "dense":
        return pack_graphs_dense(samples(SIZES), 8, 32,
                                 num_graphs=len(SIZES) + 1)
    return pack_graphs(samples(SIZES), 32, 64)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_real_rows_are_f_linear_and_padding_rows_zero(layout, bias):
    g = graph(layout)
    mask = g.node_mask
    assert 0 < int(mask.sum()) < mask.shape[0]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(mask.shape[0], 12, generator=gen)
    w = torch.randn(7, 12, generator=gen)
    b = torch.randn(7, generator=gen) if bias else None
    y = ll.lcgn_linear(x, w, b, ll.node_rows(mask))
    assert y.dtype == torch.float32
    assert torch.equal(y[mask], F.linear(x, w, b)[mask])
    assert torch.equal(y[~mask], torch.zeros_like(y[~mask]))
    # a bf16 input is cast to float32 first, as TorchLinear casts it
    y16 = ll.lcgn_linear(x.bfloat16(), w, b, ll.node_rows(mask))
    assert torch.equal(y16, ll.lcgn_linear(x.bfloat16().float(), w, b,
                                           ll.node_rows(mask)))


@pytest.mark.parametrize("need_dx,bias", [(True, True), (True, False),
                                          (False, True)])
@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_closed_form_backward_is_autograds(layout, need_dx, bias):
    """The backward kernel's plain twin against autograd through the masked
    product; padding rows of x and dy hold non-finite values, which must not
    reach any gradient."""
    g = graph(layout)
    mask = g.node_mask
    gen = torch.Generator().manual_seed(2)
    N = mask.shape[0]
    x = torch.randn(N, 12, generator=gen)
    w = torch.randn(7, 12, generator=gen)
    b = torch.randn(7, generator=gen) if bias else None
    dy = torch.randn(N, 7, generator=gen)
    dx, dw, db = ll.lcgn_linear_backward_reference(
        torch.where(mask[:, None], dy, float("nan")),
        torch.where(mask[:, None], x, float("inf")), w, mask,
        need_dx=need_dx, has_bias=bias)
    leaves = [t.clone().requires_grad_() for t in (x, w)]
    if bias:
        leaves.append(b.clone().requires_grad_())
    y = ll.lcgn_linear_reference(leaves[0], leaves[1],
                                 leaves[2] if bias else None, mask)
    want = torch.autograd.grad(y, leaves, dy)
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, want[1], **tol)
    if need_dx:
        torch.testing.assert_close(dx, want[0], **tol)
        assert torch.equal(dx[~mask], torch.zeros_like(dx[~mask]))
    else:
        assert dx is None
    if bias:
        torch.testing.assert_close(db, want[2], **tol)
    else:
        assert db is None


@pytest.mark.parametrize("layout", ["dense", "flat", "all_real", "none_real"])
def test_row_list_puts_real_rows_first_in_order(layout):
    if layout in ("dense", "flat"):
        mask = graph(layout).node_mask
    else:
        mask = torch.full((37,), layout == "all_real")
    perm, count = ll.node_rows_reference(mask)
    real = torch.nonzero(mask)[:, 0]
    pad = torch.nonzero(~mask)[:, 0]
    assert perm.dtype == count.dtype == torch.int32
    assert count.tolist() == [real.numel()]
    assert perm.long().tolist() == real.tolist() + pad.tolist()
    # on the CPU the linears need only the mask
    rows = ll.node_rows(mask)
    assert rows.perm is None and rows.count is None
    assert rows.mask is mask


def _seq_inputs(g, seed):
    gen = torch.Generator().manual_seed(seed)
    B, N, C, L = g.num_graphs, g.nodes_pad, 16, 5
    return (torch.randn(N, 12, generator=gen),
            torch.randn(B, C, generator=gen),
            torch.randn(B, L, C, generator=gen),
            torch.randn(N, C, generator=gen))


@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_lcgn_seq_equals_its_every_row_twin(layout, monkeypatch):
    """LCGNSeq with its node-wise linears over the real rows only, against
    the same module computing every padded row (the linears without the
    mask, as before the kernels): equal outputs, input and parameter
    gradients, with dropout on (the same draws on both sides)."""
    g = graph(layout)
    torch.manual_seed(0)
    seq = gnn.LCGNSeq(12, 16, 16, max_iters=2, dropout=0.1)
    with torch.no_grad():
        for p in seq.parameters():
            p.normal_(0.0, 0.3)
    x, q, mem, noise = _seq_inputs(g, 3)
    # the twin's output is unmasked: the gradient on its padded rows is what
    # the engine's consumers give them, 0
    upstream = torch.where(g.node_mask[:, None], torch.randn(
        g.nodes_pad, 16, generator=torch.Generator().manual_seed(4)), 0.0)

    def run():
        seq.zero_grad()
        xl = x.clone().requires_grad_()
        out = seq(g, xl, q, mem, generator=torch.Generator().manual_seed(5),
                  x_ctx=noise)
        out.backward(upstream)
        return out.detach(), xl.grad, {n: p.grad.clone()
                                       for n, p in seq.named_parameters()
                                       if p.grad is not None}

    got = run()
    monkeypatch.setattr(gnn, "lcgn_linear", lambda x, w, b, rows: F.linear(
        x.float(), w, b))
    want = run()
    mask = g.node_mask
    assert torch.equal(got[0][~mask], torch.zeros_like(got[0][~mask]))

    def close(a, b, name):
        torch.testing.assert_close(a, b, rtol=1e-5, msg=name,
                                   atol=1e-6 * float(b.abs().max()) + 1e-12)

    close(got[0][mask], want[0][mask], "output")
    close(got[1], want[1], "x grad")
    assert set(got[2]) == set(want[2])
    for name, grad in want[2].items():
        close(got[2][name], grad, name)
