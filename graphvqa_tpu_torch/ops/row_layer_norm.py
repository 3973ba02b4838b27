"""The Transformer stacks' LayerNorm over each row's last axis: a
hand-written CUDA kernel pair and its plain twin.

(The per-graph LayerNorm of the scene encoder, over nodes and channels
jointly, is ``ops/layernorm.py``.)

:func:`layer_norm` computes flax's ``nn.LayerNorm(epsilon, dtype)`` as
``nn/transformer.py:LayerNorm`` has it: float32 statistics, the variance as
E[x^2] - E[x]^2 clamped at 0, ``(x - mean) * (rsqrt(var + eps) * weight) +
bias``, rounded to ``dtype``. On a CPU tensor it runs
:func:`layer_norm_reference`, that arithmetic as plain tensor code, whose
backward autograd takes. On a CUDA tensor it launches ``csrc/layer_norm.cu``
or raises: one forward launch, and for autograd
(:class:`LayerNormFunction`) one backward launch over the rows and one
column reduction for the weight and bias gradients, in a fixed order, so two
runs agree bit for bit. The kernels take x in float32 or bfloat16 and y in
either, any row count from 1 and widths up to 1,024, contiguous rows.

The library builds with the other kernels (``ops/cuda_lib.py``, one nvcc
per source, in parallel); its launchers pick the kernel's variant and grid
from the dtypes, the width and the pointers' alignment. Each forward and
backward launch counts itself on the card (``cuda_lib.launch_counts``; a
CUDA graph's replay counts its launches).
"""
from __future__ import annotations

import ctypes

import torch

from graphvqa_tpu_torch.ops import cuda_lib
from graphvqa_tpu_torch.ops.cuda_lib import DTYPE_CODES

# the widest row the kernels take (csrc/layer_norm.cu: kMaxD)
_MAX_WIDTH = 1024
_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the library's launchers: {function: (argtypes, restype)}
_LAUNCHERS = {
    "layer_norm_forward_launch": ([_ci] * 2 + [_vp] * 5
                                  + [_ci, _ci, _cf, _vp, _vp], _ci),
    "layer_norm_backward_blocks": ([_ci], _ci),
    "layer_norm_backward_launch": ([_ci] * 2 + [_vp] * 8 + [_ci] * 3
                                   + [_vp, _vp], _ci)}


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """The plain twin: flax's LayerNorm over the last axis in tensor ops."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias
    return y.to(dtype)


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{tuple(DTYPE_CODES)}")
    if t.ndim < 1 or t.numel() == 0:
        raise ValueError(f"{name} must hold at least one row, got shape "
                         f"{tuple(t.shape)}")
    if t.shape[-1] > _MAX_WIDTH:
        raise ValueError(f"{name} rows are {t.shape[-1]} wide; the kernel "
                         f"takes up to {_MAX_WIDTH}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (rows of stride "
                         f"{t.shape[-1]})")


def _check_vector(name: str, t: torch.Tensor, d: int) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (d,):
        raise ValueError(f"{name} must be float32 [{d}], got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_devices(x: torch.Tensor, *others) -> None:
    """x on a card and every other tensor on x's (checked last, so that the
    CPU tests reach every other check)."""
    if x.device.type != "cuda":
        raise ValueError(f"the layer-norm kernels run on cuda, x is on "
                         f"{x.device}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"a tensor on {t.device}, x on {x.device}")


def layer_norm_forward(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float, dtype: torch.dtype,
                       keep_stats: bool = False):
    """The forward kernel -> (y in ``dtype``, x's shape; with
    ``keep_stats`` the statistics [rows, 2] f32 for the backward: the mean
    and rstd, rstd negated where the clamp was active; else None)."""
    _check_rows("x", x)
    if dtype not in DTYPE_CODES:
        raise TypeError(f"output dtype {dtype}, expected one of "
                        f"{tuple(DTYPE_CODES)}")
    d, dev = x.shape[-1], x.device
    _check_vector("weight", weight, d)
    _check_vector("bias", bias, d)
    _check_devices(x, weight, bias)
    y = torch.empty(x.shape, dtype=dtype, device=dev)
    rows = x.numel() // d
    stats = (torch.empty((rows, 2), dtype=torch.float32, device=dev)
             if keep_stats else None)
    args = (DTYPE_CODES[x.dtype], DTYPE_CODES[dtype], x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            None if stats is None else stats.data_ptr(), rows, d, float(eps),
            cuda_lib.launch_word("layer_norm", dev).data_ptr())
    cuda_lib.launch(cuda_lib.bind("layer_norm", _LAUNCHERS)
                    .layer_norm_forward_launch, args, dev, "layer_norm")
    return y, stats


def layer_norm_backward(dy: torch.Tensor, x: torch.Tensor,
                        weight: torch.Tensor, stats: torch.Tensor):
    """The backward kernels -> (dx in x's dtype, dweight [D] f32, dbias [D]
    f32) from the upstream gradient ``dy`` (y's dtype, x's shape) and the
    forward's ``stats``."""
    _check_rows("x", x)
    _check_rows("dy", dy)
    d, dev = x.shape[-1], x.device
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    _check_vector("weight", weight, d)
    rows = x.numel() // d
    if (stats.dtype != torch.float32 or tuple(stats.shape) != (rows, 2)
            or not stats.is_contiguous()):
        raise ValueError(f"stats must be float32 [{rows}, 2], contiguous")
    _check_devices(x, dy, weight, stats)
    lib = cuda_lib.bind("layer_norm", _LAUNCHERS)
    blocks = cuda_lib.on_device(dev, lib.layer_norm_backward_blocks, rows)
    if blocks < 1:
        raise RuntimeError(f"layer_norm_backward found no grid for {rows} "
                           f"rows on {dev}")
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, 2, d), dtype=torch.float32, device=dev)
    dweight = torch.empty(d, dtype=torch.float32, device=dev)
    dbias = torch.empty_like(dweight)
    args = (DTYPE_CODES[x.dtype], DTYPE_CODES[dy.dtype], dy.data_ptr(),
            x.data_ptr(), weight.data_ptr(), stats.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), rows,
            d, blocks,
            cuda_lib.launch_word("layer_norm_backward", dev).data_ptr())
    cuda_lib.launch(lib.layer_norm_backward_launch, args, dev,
                    "layer_norm_backward")
    return dx, dweight, dbias


class LayerNormFunction(torch.autograd.Function):
    """The kernel pair in autograd: the forward keeps x and 8 bytes of
    statistics a row; the backward recomputes x's normalised values."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype):
        y, stats = layer_norm_forward(x, weight, bias, eps, dtype,
                                      keep_stats=True)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        dx, dweight, dbias = layer_norm_backward(dy.contiguous(), x, weight,
                                                 stats)
        return dx, dweight, dbias, None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over x's last axis -> ``dtype`` (module doc): the plain
    twin on a CPU tensor, the kernels on a CUDA tensor (through
    :class:`LayerNormFunction` when autograd needs the backward)."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps, dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        return LayerNormFunction.apply(x, weight, bias, eps, dtype)
    return layer_norm_forward(x, weight, bias, eps, dtype)[0]
