"""LCGN's node-wise float32 linears over the real node rows only: a
hand-written CUDA kernel pair and its plain twin.

Replaces no TPU kernel: the JAX package's ``GlorotLinear`` and ``nn.Dense``
in ``LCGNSeq`` / ``LCGNCell`` are XLA dots over every padded node row. Each
LCGN step runs its node-wise linears (``init_sg_emb_input``,
``proj_x_loc``, ``fin_layer`` once; ``proj_x_ctx``, ``lin_l`` / ``lin_r`` /
``cal_x`` and ``output_layer`` per iteration) over all ``B * npg`` rows, and
on GQA-shaped scenes (median 16 objects in 64-row blocks) about 72 % of
those rows are padding whose results every consumer masks: padded edges
leave the softmax, their columns of the aggregation are zero, and the
outputs are ``where(node_mask, ..., 0)``. So the padding rows' gradient is
exactly 0, and dropping them changes only the order of the sums.

:func:`lcgn_linear` computes ``y = where(mask, x @ W^T + b, 0)`` in float32:

  * the real rows' products, the padding rows exactly 0;
  * backward: ``dx = where(mask, dy @ W, 0)``, ``dW = sum over real rows of
    dy[r]^T x[r]``, ``db = sum over real rows of dy[r]``.

Bound (H100, 67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s): operations.
At B=200, npg=64 (12,800 rows, ~3,550 real) a step's linears are ~96 GFLOP
forward and twice that backward on the real rows, ~4.3 ms at the peak; the
bytes (x and dy read once, y and dx written once, W from L2) are a tenth of
that time. What the design does about it (``csrc/lcgn_linear.cuh``):

1. The row list, built once a forward on the card (:func:`node_rows`): one
   block lists the mask's real rows, then its padding rows, each in order
   (``perm``), and counts the real ones (``count``). No ``nonzero`` and no
   host sync, so the step's CUDA graph captures it; every linear of the
   forward and its backward reuse it.
2. Full tiles on the compacted rows: a block computes a 128 x 128 tile of
   (position in the list, output column) from x's rows gathered by ``perm``
   into shared memory with 16-byte ``cp.async`` pieces (one float where the
   widths or addresses do not allow 16 bytes), W (at most 9.4 MB, L2
   resident) read in place, three stages in flight; each thread keeps an
   8 x 8 micro-tile in registers, FFMA only, float32 accumulation (no TF32,
   whatever ``allow_tf32`` says); one block an SM, as both operands are
   read k-contiguous and two blocks an SM spill. The grid covers every
   position; blocks whose positions are all padding write their zeros and
   stop.
3. The backward is one launch: dW's tiles first, as a split-K over at most
   8 runs of the real rows (both operands gathered), then dx's tiles as the
   forward's, W's rows the k; db from the staged dy of dW's first column of
   tiles. Each split writes its own partial and a second launch adds them
   in split order: no atomics, so two runs give the same bits.

LCGN reads ``lin_l``, ``lin_r`` and ``cal_x`` (all of ``x_joint``) as one
linear of their concatenated weights (``nn/gnn.py:LCGNCell``), so a launch
fills the card three times over where one of 512 columns fills it once.

On a CPU tensor :func:`lcgn_linear` runs :func:`lcgn_linear_reference` (and
autograd's backward through it): the same product, then the mask. On a CUDA
tensor it launches ``csrc/lcgn_linear.cu`` (and, in autograd's backward,
``csrc/lcgn_linear_backward.cu``) or raises. Both build with the port's
other kernels (``ops/cuda_lib.py``), launch on the current stream and set
their shared-memory attribute on an eager launch only, so the step graphs
(``train/graphs.py``) replay them. Each launch counts itself on the card
(``cuda_lib.launch_counts``: ``lcgn_rows``, ``lcgn_linear``,
``lcgn_linear_backward``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from graphvqa_tpu_torch.ops import cuda_lib
from graphvqa_tpu_torch.ops.cuda_lib import check_tensor

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# each library's launchers: {function: (argtypes, restype)}
_FORWARD = {"lcgn_rows_launch": ([_vp] * 4 + [_ci, _vp], _ci),
            "lcgn_linear_launch": ([_vp] * 7 + [_ci] * 3 + [_vp], _ci)}
_BACKWARD = {"lcgn_linear_backward_splits": ([_ci, _ci], _ci),
             "lcgn_linear_backward_launch": ([_vp] * 9 + [_ci, _vp]
                                             + [_ci] * 3 + [_vp], _ci)}


class NodeRows(NamedTuple):
    """The node rows the linears compute: ``mask`` [N] bool (true on real
    rows) and, on the card, the list :func:`node_rows` built from it:
    ``perm`` [N] int32 (real rows, then padding rows, each in order) and
    ``count`` [1] int32 (how many are real)."""
    mask: torch.Tensor
    perm: Optional[torch.Tensor] = None
    count: Optional[torch.Tensor] = None


def node_rows_reference(mask: torch.Tensor):
    """Plain twin of the row list: (perm [N] int32, count [1] int32)."""
    perm = torch.argsort((~mask).to(torch.uint8), stable=True)
    return perm.to(torch.int32), mask.sum().to(torch.int32).reshape(1)


def node_rows(mask: torch.Tensor) -> NodeRows:
    """The rows of ``mask`` [N] bool for :func:`lcgn_linear`: on the card
    the list the kernel builds there (counted as ``lcgn_rows``), on the CPU
    the mask alone."""
    if mask.device.type == "cpu":
        return NodeRows(mask)
    dev = mask.device
    N = mask.shape[0]
    check_tensor("node_mask", mask, (N,), (torch.bool,), dev)
    if N < 1:
        raise ValueError("lcgn_linear needs at least one node row")
    perm = torch.empty(N, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    cuda_lib.launch(cuda_lib.bind("lcgn_linear", _FORWARD).lcgn_rows_launch,
                    (mask.data_ptr(), perm.data_ptr(), count.data_ptr(),
                     cuda_lib.launch_word("lcgn_rows", dev).data_ptr(), N),
                    dev, "lcgn_rows")
    return NodeRows(mask, perm, count)


def lcgn_linear_reference(x, weight, bias, mask):
    """Plain twin of the forward kernel: x [N, K], weight [Nout, K], bias
    [Nout] or None, mask [N] bool -> where(mask, x @ W^T + b, 0) [N, Nout]
    float32. Differentiable: autograd through it is the backward's
    arithmetic in another order."""
    return torch.where(mask[:, None], F.linear(x, weight, bias), 0.0)


def lcgn_linear_backward_reference(dy, x, weight, mask, *, need_dx=True,
                                   has_bias=True):
    """Plain twin of the backward kernel: (dx or None, dW, db or None) of
    :func:`lcgn_linear_reference` for dy [N, Nout], the padding rows of dy
    and x left out of the sums."""
    m = mask[:, None]
    dym = torch.where(m, dy, 0.0)
    dx = torch.where(m, dym @ weight, 0.0) if need_dx else None
    dw = dym.t() @ torch.where(m, x, 0.0)
    return dx, dw, (dym.sum(0) if has_bias else None)


def _check_cuda_inputs(x, weight, perm, count):
    dev = x.device
    N, K = x.shape
    f32 = (torch.float32,)
    check_tensor("x", x, (N, K), f32, dev)
    check_tensor("weight", weight, (weight.shape[0], K), f32, dev)
    check_tensor("perm", perm, (N,), (torch.int32,), dev)
    check_tensor("count", count, (1,), (torch.int32,), dev)
    if min(N, K, weight.shape[0]) < 1:
        raise ValueError(f"lcgn_linear needs N, K, Nout >= 1, got "
                         f"{(N, K, weight.shape[0])}")


def _forward(x, weight, bias, perm, count):
    _check_cuda_inputs(x, weight, perm, count)
    dev = x.device
    N, K = x.shape
    Nout = weight.shape[0]
    if bias is not None:
        check_tensor("bias", bias, (Nout,), (torch.float32,), dev)
    y = torch.empty((N, Nout), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), perm.data_ptr(),
            count.data_ptr(), y.data_ptr(),
            cuda_lib.launch_word("lcgn_linear", dev).data_ptr(), N, K, Nout)
    cuda_lib.launch(cuda_lib.bind("lcgn_linear", _FORWARD).lcgn_linear_launch,
                    args, dev, "lcgn_linear")
    return y


def lcgn_linear_backward(dy, x, weight, perm, count, *, need_dx=True,
                         has_bias=True):
    """The backward kernel on CUDA tensors -> (dx or None, dW, db or None),
    as :func:`lcgn_linear_backward_reference` documents (counted on the
    card, ``cuda_lib.launch_counts``)."""
    _check_cuda_inputs(x, weight, perm, count)
    dev = x.device
    N, K = x.shape
    Nout = weight.shape[0]
    check_tensor("dy", dy, (N, Nout), (torch.float32,), dev)
    lib = cuda_lib.bind("lcgn_linear_backward", _BACKWARD)
    splits = cuda_lib.on_device(dev, lib.lcgn_linear_backward_splits, K, Nout)
    if splits < 1:
        raise RuntimeError("lcgn_linear_backward_splits failed")
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(weight)
    db = torch.empty(Nout, dtype=torch.float32, device=dev) if has_bias \
        else None
    partial = (torch.empty(splits * (Nout * K + Nout), dtype=torch.float32,
                           device=dev) if splits > 1 else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (dy.data_ptr(), x.data_ptr(), weight.data_ptr(), perm.data_ptr(),
            count.data_ptr(), ptr(dx), dw.data_ptr(), ptr(db), ptr(partial),
            splits,
            cuda_lib.launch_word("lcgn_linear_backward", dev).data_ptr(),
            N, K, Nout)
    cuda_lib.launch(lib.lcgn_linear_backward_launch, args, dev,
                    "lcgn_linear_backward")
    return dx, dw, db


class LCGNLinearFunction(torch.autograd.Function):
    """The pair in autograd; saves x, the weight and the row list."""

    @staticmethod
    def forward(ctx, x, weight, bias, perm, count):
        ctx.save_for_backward(x, weight, perm, count)
        ctx.has_bias = bias is not None
        return _forward(x, weight, bias, perm, count)

    @staticmethod
    def backward(ctx, dy):
        x, weight, perm, count = ctx.saved_tensors
        dx, dw, db = lcgn_linear_backward(
            dy.contiguous(), x, weight, perm, count,
            need_dx=ctx.needs_input_grad[0], has_bias=ctx.has_bias)
        return dx, dw, db, None, None


def lcgn_linear(x, weight, bias, rows: NodeRows):
    """``where(rows.mask, x @ W^T + b, 0)`` in float32 (module doc): x [N,
    K] (cast to float32), weight [Nout, K], bias [Nout] or None, rows from
    :func:`node_rows` on x's device. CUDA tensors launch the kernels
    (through :class:`LCGNLinearFunction` when autograd needs the backward);
    CPU tensors run the plain version."""
    x = x.float()
    if x.device.type == "cpu":
        return lcgn_linear_reference(x, weight, bias, rows.mask)
    if rows.perm is None:
        raise ValueError("lcgn_linear on the card needs node_rows built on "
                         "the card")
    args = (x.contiguous(), weight.contiguous(), bias, rows.perm, rows.count)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args[:3]):
        return LCGNLinearFunction.apply(*args)
    return _forward(*args)
