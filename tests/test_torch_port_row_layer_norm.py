"""The Transformer stacks' LayerNorm (``ops/row_layer_norm.py``) on the CPU.

On a CPU tensor ``nn/transformer.py:LayerNorm`` runs the plain twin, which
must stay today's composite bit for bit (forward and autograd's backward),
so the parity tests against the JAX package keep their reference. The
kernels' backward is specified in closed form
(``torch_port_fixtures.layer_norm_backward_closed_form``); here that form is
held to autograd through the composite: float32 within 1e-5 relative and
1e-6 of the largest element (the same float32 terms summed in another
order), bfloat16 dx within one bfloat16 step (both round a float32 value
that differs only at round-off). The kernel wrappers refuse what the
kernels do not take, before any build. The kernels themselves are held to
the composite on the card in test_torch_port_cuda.py.
"""
import pytest
import torch

from graphvqa_tpu_torch.nn.transformer import LayerNorm
from graphvqa_tpu_torch.ops import row_layer_norm as rln
from graphvqa_tpu_torch.ops.cuda_lib import launch_counts
from torch_port_fixtures import (layer_norm_backward_closed_form,
                                 layer_norm_rows)

EPS = 1e-5
PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]


def _composite(x, weight, bias, eps, dtype):
    """nn/transformer.py:LayerNorm.forward before the kernels, verbatim."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias
    return y.to(dtype)


def _affine(d, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(d, generator=gen) * 0.5 + 1.0,
            torch.randn(d, generator=gen) * 0.1)


@pytest.mark.parametrize("x_dtype,y_dtype", PAIRS)
def test_module_on_the_cpu_is_the_composite(x_dtype, y_dtype):
    """Forward, and the gradients autograd gives, equal bit for bit."""
    d = 48
    norm = LayerNorm(d, dtype=y_dtype)
    w, b = _affine(d, seed=1)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    x = layer_norm_rows("random", 2 * 7, d, seed=2).reshape(2, 7, d).to(
        x_dtype)
    dy = torch.randn(2, 7, d, generator=torch.Generator().manual_seed(3)).to(
        y_dtype)
    x1 = x.clone().requires_grad_()
    y1 = norm(x1)
    y1.backward(dy)
    x2, w2, b2 = (t.clone().requires_grad_() for t in (x, w, b))
    y2 = _composite(x2, w2, b2, EPS, y_dtype)
    y2.backward(dy)
    assert y1.dtype == y_dtype and torch.equal(y1, y2)
    assert torch.equal(x1.grad, x2.grad)
    assert torch.equal(norm.weight.grad, w2.grad)
    assert torch.equal(norm.bias.grad, b2.grad)
    counts = launch_counts()              # no kernel on the CPU
    assert counts["layer_norm"] == counts["layer_norm_backward"] == 0


def _within_one_bf16_step(got, want):
    """|got - want| at most one bfloat16 step at the larger magnitude."""
    big = torch.maximum(got.float().abs(), want.float().abs())
    _, exp = torch.frexp(big)
    step = torch.ldexp(torch.ones_like(big), exp - 8)
    assert bool(((got.float() - want.float()).abs() <= step).all())


@pytest.mark.parametrize("d", [512, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "constant", "zero"])
def test_closed_form_backward_is_autograd_through_the_composite(kind, dtype,
                                                                 d):
    rows = 64
    x = layer_norm_rows(kind, rows, d, seed=4).to(dtype)
    w, b = _affine(d, seed=5)
    dy = torch.randn(rows, d, generator=torch.Generator().manual_seed(6)).to(
        dtype)
    if kind == "constant" and dtype == torch.float32:
        xf = x.float()
        mean = xf.mean(dim=-1)
        var = (xf * xf).mean(dim=-1) - mean * mean
        assert bool((var < 0).any()), "no row has its clamp active"
    xa, wa, ba = (t.clone().requires_grad_() for t in (x, w, b))
    _composite(xa, wa, ba, EPS, dtype).backward(dy)
    dx, dw, db = layer_norm_backward_closed_form(dy, x, w, EPS)
    assert dx.dtype == dtype
    if dtype == torch.float32:
        scale = xa.grad.abs().max().item()
        torch.testing.assert_close(dx, xa.grad, rtol=1e-5, atol=1e-6 * scale)
    else:
        _within_one_bf16_step(dx, xa.grad)
    for got, want in ((dw, wa.grad), (db, ba.grad)):
        torch.testing.assert_close(
            got, want, rtol=1e-5, atol=1e-6 * max(want.abs().max().item(),
                                                  1e-30))


def _row_inputs(d=64, rows=5, dtype=torch.float32):
    w, b = _affine(d, seed=7)
    return layer_norm_rows("random", rows, d, seed=8).to(dtype), w, b


@pytest.mark.parametrize("case,match", [
    ("cpu_tensor", "run on cuda"), ("float16_x", "dtype"),
    ("float64_x", "dtype"), ("float16_out", "output dtype"),
    ("transposed_x", "contiguous"), ("strided_rows", "contiguous"),
    ("no_rows", "at least one row"), ("too_wide", "1024"),
    ("float64_weight", "weight must be float32")])
def test_forward_wrapper_refuses(case, match):
    x, w, b = _row_inputs()
    dtype = torch.bfloat16
    if case == "float16_x":
        x = x.half()
    elif case == "float64_x":
        x = x.double()
    elif case == "float16_out":
        dtype = torch.float16
    elif case == "transposed_x":
        x = _row_inputs(d=5, rows=64)[0].t()
    elif case == "strided_rows":
        x = torch.zeros(5, 128)[:, :64]
    elif case == "no_rows":
        x = x[:0]
    elif case == "too_wide":
        x, w, b = _row_inputs(d=1030)
    elif case == "float64_weight":
        w = w.double()
    with pytest.raises((TypeError, ValueError), match=match):
        rln.layer_norm_forward(x, w, b, EPS, dtype)


@pytest.mark.parametrize("case,match", [
    ("cpu_tensor", "run on cuda"), ("float16_dy", "dtype"),
    ("strided_dy", "contiguous"), ("shape_mismatch", "does not match"),
    ("bad_stats", "stats")])
def test_backward_wrapper_refuses(case, match):
    x, w, _ = _row_inputs()
    dy = torch.ones_like(x)
    stats = torch.zeros(x.shape[0], 2)
    if case == "float16_dy":
        dy = dy.half()
    elif case == "strided_dy":
        dy = torch.ones(5, 128)[:, :64]
    elif case == "shape_mismatch":
        dy = dy[:3]
    elif case == "bad_stats":
        stats = stats[:, :1]
    with pytest.raises((TypeError, ValueError), match=match):
        rln.layer_norm_backward(dy, x, w, stats)
