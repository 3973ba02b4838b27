"""The fused GAT round: a hand-written CUDA kernel and its plain twin.

``gat_round`` computes the forward contract of the JAX package's
``ops/dense.py:dense_gat_aggregate`` on the dense layout (whose TPU kernel is
``ops/pallas/fused_dense_gat.py:pallas_fused_dense_gat``): per-edge logits
``leaky_relu(al[src] + ar[dst] + ae)``, the destination softmax with the
'graph' or 'dst' shift, the attention-weighted sum of ``xw[src]`` per
destination, the head mean, and the per-graph ``ins_value`` share through the
attention row sums.

On a CUDA tensor the wrapper launches ``csrc/gat_round.cu`` (built and
bound by ``ops/cuda_lib.py`` at first use) or raises; on a CPU tensor it
runs :func:`gat_round_reference`, the same math in index ops. The kernel
takes any 2-byte aligned ``xw`` and ``out``: it copies a graph's rows with
one bulk copy where they are 16-byte aligned and in smaller pieces where
not. Its blocks take graphs from a counter, a 4-byte tensor that the
wrapper allocates per call and the library zeroes on the stream before each
launch.

Training adds two options to the forward, the attention dropout scale
``keep_scale`` and the attention output (``return_alpha``), and a backward:
``gat_round_backward`` launches ``csrc/gat_round_backward.cu`` on CUDA
tensors and runs :func:`gat_round_backward_reference` on CPU tensors, and
:class:`GATRoundFunction` ties both directions into autograd. The backward
gives the JAX package's gradient, including its derivative of 1/2 where an
edge's logit equals the softmax shift (``minimum`` at a tie). Its blocks take
(graph, head) units from a counter of their own, allocated and zeroed the
same way, which ends holding the number of units handed out
(:func:`_backward_launch` returns it beside the gradients).

Both kernels launch on the current stream, so a CUDA graph can hold them
(``train/graphs.py``). The libraries set a kernel's shared-memory attribute
and query its occupancy on the first eager launch at each size; a launch
that would need either while its stream captures raises instead. Each
launch counts itself where it runs: block 0 adds one to a 64-bit word of
its kernel on its card, so a graph's replay, which runs no Python, counts
its launches as eager calls do (``cuda_lib.launch_counts``).

The wrapper takes each graph's edges as the dense packing lays them out
(``core/packing.py:pack_graphs_dense``): the real edges first, sorted by
destination, the padded ones last. On the CPU it raises on any other order;
on the card the kernel's device assert stops it.
"""
from __future__ import annotations

import ctypes

import torch

from graphvqa_tpu_torch.ops import cuda_lib
from graphvqa_tpu_torch.ops.cuda_lib import DTYPE_CODES, check_tensor
from graphvqa_tpu_torch.ops.dense import (
    NEG_INF, SOFTMAX_EPS, dense_edges, edges_dst_sorted)

_SHIFTS = ("graph", "dst")
_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the launchers of each direction's library: {function: (argtypes, restype)}
_FORWARD = {
    "gat_round_launch": ([_ci] + [_vp] * 14 + [_ci] * 5 + [_cf, _ci, _vp],
                         _ci),
    "gat_round_smem_bytes": ([_ci] * 5, ctypes.c_size_t)}
_BACKWARD = {
    "gat_round_backward_launch": (
        [_ci] + [_vp] * 18 + [_ci] * 5 + [_cf, _ci, _vp], _ci),
    "gat_round_backward_smem_bytes": ([_ci] * 5, ctypes.c_size_t)}
# per device index: the shared memory a block may opt into; per (kernel, npg,
# epg, H, C, dtype): the least the kernel needs. Both fixed for a process.
_smem_limit: dict = {}
_smem_need: dict = {}


def _edge_terms(dl, sl, mask, alpha_l, alpha_r, alpha_e, npg, epg,
                negative_slope, shift, shift_max=None):
    """Per-edge terms of the round on the flat [B*epg] edge axis: (real,
    dst, src, z, shifted) with z the logit before the leaky ReLU and
    ``shifted`` the logit after it (-1e30 on padded edges) minus the softmax
    shift, which is detached (the JAX package's stop_gradient;
    ``shift_max`` [B, H] replaces the graph's max in the 'graph' shift)."""
    if shift not in _SHIFTS:
        raise ValueError(f"unknown softmax shift {shift!r}")
    B = dl.shape[0]
    N, H = alpha_l.shape
    dev = alpha_l.device
    real, src, dst = dense_edges(dl, sl, mask, npg)
    z = (alpha_l.float().index_select(0, src)
         + alpha_r.float().index_select(0, dst)) \
        + alpha_e.float().reshape(B * epg, H)
    lg = torch.where(z >= 0, z, negative_slope * z)
    lg = torch.where(real[:, None], lg, NEG_INF)
    with torch.no_grad():
        if shift == "graph":
            gmax = (lg.reshape(B, epg, H).amax(dim=1) if shift_max is None
                    else shift_max.float()).clamp(min=NEG_INF)
            shift_e = gmax.repeat_interleave(epg, dim=0)
        else:
            dmax = torch.full((N, H), NEG_INF, device=dev).scatter_reduce(
                0, dst[:, None].expand(-1, H), lg, reduce="amax")
            shift_e = dmax.index_select(0, dst)
    return real, dst, src, z, lg - shift_e


def graph_logit_max(dl, sl, mask, alpha_l, alpha_r, alpha_e, *, npg,
                    negative_slope=0.2) -> torch.Tensor:
    """[B, H] f32: each graph's largest logit over its real edges, computed
    as the kernels compute their 'graph' shift (-1e30 for a graph without
    edges). An edge-sharded round takes the edge group's max of it as
    ``shift_max``, so the shift, and the tie at the maximum that JAX's
    gradient halves, are those of the whole graph."""
    epg = dl.shape[1]
    _, _, _, _, shifted = _edge_terms(
        dl, sl, mask, alpha_l, alpha_r, alpha_e.float(), npg, epg,
        negative_slope, "graph", torch.zeros(dl.shape[0], alpha_l.shape[1],
                                             device=alpha_l.device))
    return shifted.detach().reshape(dl.shape[0], epg, -1).amax(dim=1)


def gat_round_reference(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
                        ins_value=None, *, npg, epg, negative_slope=0.2,
                        shift="graph", keep_scale=None, return_alpha=False,
                        shift_max=None):
    """Plain torch twin of the kernel (same arguments, same math).

    dl/sl [B, epg] local indices, mask [B, epg] (>0 = real edge), alpha_l /
    alpha_r [B*npg, H] f32, alpha_e [B, epg, H], xw [B*npg, H, C],
    ins_value [B, H, C] or None, keep_scale [B, epg, H] f32 or None (the
    attention dropout scale, 0 or 1/(1-rate), applied to exp() after the
    denominator), shift_max [B, H] f32 or None (the 'graph' shift given)
    -> out [B*npg, C] in xw's dtype, accumulated in float32;
    with ``return_alpha`` also the dropped attention exp / (den + 1e-16)
    [B*epg, H] in xw's dtype.

    Differentiable: the shift is detached and exp takes ``minimum(shifted,
    0)``, whose derivative at a tie is 1/2 as in JAX, so torch.autograd
    through this function gives the JAX package's gradient.
    """
    B = dl.shape[0]
    N, H, C = xw.shape
    dev = xw.device
    real, dst, src, _, shifted = _edge_terms(
        dl, sl, mask, alpha_l, alpha_r, alpha_e, npg, epg, negative_slope,
        shift, shift_max)
    p = torch.where(real[:, None],
                    torch.exp(torch.minimum(shifted, torch.zeros_like(
                        shifted))), 0.0)
    denom = torch.zeros(N, H, device=dev).index_add(0, dst, p)
    if keep_scale is not None:
        p = p * keep_scale.float().reshape(B * epg, H)
    recip = (1.0 / H) / (denom + SOFTMAX_EPS)
    a = p * recip.index_select(0, dst)                           # [E, H]
    msgs = torch.einsum("eh,ehc->ec", a, xw.float().index_select(0, src))
    out = torch.zeros(N, C, device=dev).index_add(0, dst, msgs)
    if ins_value is not None:
        rowsum = torch.zeros(N, H, device=dev).index_add(0, dst, a)
        out = out + torch.einsum("bnh,bhc->bnc", rowsum.reshape(B, npg, H),
                                 ins_value.float()).reshape(N, C)
    out = out.to(xw.dtype)
    if not return_alpha:
        return out
    alpha = p / (denom.index_select(0, dst) + SOFTMAX_EPS)
    return out, torch.where(real[:, None], alpha, 0.0).to(xw.dtype)


def gat_round_backward_reference(grad_out, dl, sl, mask, alpha_l, alpha_r,
                                 alpha_e, xw, ins_value=None,
                                 keep_scale=None, *, npg, epg,
                                 negative_slope=0.2, shift="graph",
                                 shift_max=None):
    """Plain torch twin of the backward kernel: the vjp of
    :func:`gat_round_reference` for the upstream gradient ``grad_out``
    [B*npg, C], in closed form (the terms of csrc/gat_round_backward.cu),
    accumulated in float32 -> (d_xw [B*npg, H, C] in xw's dtype, d_alpha_l,
    d_alpha_r [B*npg, H] f32, d_alpha_e [B, epg, H] f32, d_ins_value
    [B, H, C] in its dtype or None)."""
    B = dl.shape[0]
    N, H, C = xw.shape
    dev = xw.device
    with torch.no_grad():
        real, dst, src, z, shifted = _edge_terms(
            dl, sl, mask, alpha_l, alpha_r, alpha_e, npg, epg,
            negative_slope, shift, shift_max)
        r1 = real[:, None]
        p = torch.where(r1, torch.exp(shifted.clamp(max=0.0)), 0.0)
        k = (torch.ones_like(p) if keep_scale is None
             else keep_scale.float().reshape(B * epg, H))
        den = torch.zeros(N, H, device=dev).index_add_(0, dst, p)
        den_e = den.index_select(0, dst) + SOFTMAX_EPS
        r = (1.0 / H) / den_e
        a = p * k * r                                            # [E, H]
        g = grad_out.float()
        g_e = g.index_select(0, dst)                             # [E, C]
        u = torch.einsum("ec,ehc->eh", g_e, xw.float().index_select(0, src))
        if ins_value is not None:
            v = torch.einsum("bnc,bhc->bnh", g.reshape(B, npg, C),
                             ins_value.float()).reshape(N, H)
            u = u + v.index_select(0, dst)
        su = torch.zeros(N, H, device=dev).index_add_(0, dst, u * a)
        dp = k * r * u - su.index_select(0, dst) / den_e
        tie = torch.where(shifted == 0, 0.5, 1.0)
        slope = torch.where(z >= 0, 1.0, negative_slope)
        dz = torch.where(r1, dp * p * tie * slope, 0.0)
        d_al = torch.zeros(N, H, device=dev).index_add_(0, src, dz)
        d_ar = torch.zeros(N, H, device=dev).index_add_(0, dst, dz)
        d_xw = torch.zeros(N, H, C, device=dev).index_add_(
            0, src, a[:, :, None] * g_e[:, None, :])
        d_ins = None
        if ins_value is not None:
            rowsum = torch.zeros(N, H, device=dev).index_add_(0, dst, a)
            d_ins = torch.einsum("bnh,bnc->bhc", rowsum.reshape(B, npg, H),
                                 g.reshape(B, npg, C)).to(ins_value.dtype)
    return (d_xw.to(xw.dtype), d_al, d_ar, dz.reshape(B, epg, H), d_ins)


def _smem_check(kind, need_fn, key, dev):
    """Raise when a block of ``kind`` at these widths needs more shared
    memory than the card lets a block opt into."""
    need = _smem_need.get((kind,) + key)
    if need is None:
        need = _smem_need[(kind,) + key] = need_fn()
    index = cuda_lib.device_index(dev)
    limit = _smem_limit.get(index)
    if limit is None:
        limit = _smem_limit[index] = getattr(
            torch.cuda.get_device_properties(index),
            "shared_memory_per_block_optin", 232448)
    if need > limit:
        raise ValueError(f"{kind} at (npg, epg, H, C) = {key[:4]} needs "
                         f"{need} B of shared memory per block; the card "
                         f"allows {limit}")


def _check_cuda_inputs(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
                       ins_value, keep_scale, npg, epg, shift,
                       shift_max=None):
    if xw.device.type != "cuda":
        raise ValueError(f"gat_round runs on cuda or cpu, not {xw.device}")
    if shift not in _SHIFTS:
        raise ValueError(f"unknown softmax shift {shift!r}")
    if xw.ndim != 3:
        raise ValueError(f"xw must be [B*npg, H, C], got {tuple(xw.shape)}")
    B = dl.shape[0]
    N, H, C = xw.shape
    dev = xw.device
    f32 = (torch.float32,)
    check_tensor("xw", xw, (B * npg, H, C), tuple(DTYPE_CODES), dev)
    check_tensor("dl", dl, (B, epg), (torch.int32,), dev)
    check_tensor("sl", sl, (B, epg), (torch.int32,), dev)
    check_tensor("mask", mask, (B, epg), f32, dev)
    check_tensor("alpha_l", alpha_l, (N, H), f32, dev)
    check_tensor("alpha_r", alpha_r, (N, H), f32, dev)
    check_tensor("alpha_e", alpha_e, (B, epg, H), f32, dev)
    if ins_value is not None:
        check_tensor("ins_value", ins_value, (B, H, C), (xw.dtype,), dev)
    if keep_scale is not None:
        check_tensor("keep_scale", keep_scale, (B, epg, H), f32, dev)
    if shift_max is not None:
        check_tensor("shift_max", shift_max, (B, H), f32, dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw, ins_value,
             keep_scale, npg, epg, negative_slope, shift, return_alpha,
             shift_max=None):
    """-> (out, alpha or None): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if xw.device.type == "cpu":
        if not edges_dst_sorted(dl, sl, mask, npg):
            raise ValueError("gat_round needs each graph's real edges first "
                             "and sorted by destination, padding last")
        got = gat_round_reference(
            dl, sl, mask, alpha_l, alpha_r, alpha_e, xw, ins_value, npg=npg,
            epg=epg, negative_slope=negative_slope, shift=shift,
            keep_scale=keep_scale, return_alpha=return_alpha,
            shift_max=shift_max)
        return got if return_alpha else (got, None)
    _check_cuda_inputs(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
                       ins_value, keep_scale, npg, epg, shift, shift_max)
    B = dl.shape[0]
    N, H, C = xw.shape
    dev = xw.device
    lib = cuda_lib.bind("gat_round", _FORWARD)
    code = DTYPE_CODES[xw.dtype]
    _smem_check("gat_round",
                lambda: lib.gat_round_smem_bytes(npg, epg, H, C, code),
                (npg, epg, H, C, code), dev)
    out = torch.empty((N, C), dtype=xw.dtype, device=dev)
    alpha = (torch.empty((B * epg, H), dtype=xw.dtype, device=dev)
             if return_alpha else None)
    # the kernel's graph counter, which the library zeroes on the stream
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    args = (code, dl.data_ptr(), sl.data_ptr(), mask.data_ptr(),
            alpha_l.data_ptr(), alpha_r.data_ptr(), alpha_e.data_ptr(),
            _ptr(keep_scale), _ptr(shift_max), xw.data_ptr(), _ptr(ins_value),
            out.data_ptr(),
            _ptr(alpha), counter.data_ptr(),
            cuda_lib.launch_word("gat_round", dev).data_ptr(), B, npg, epg,
            H, C, float(negative_slope), int(shift == "graph"))
    cuda_lib.launch(lib.gat_round_launch, args, dev, "gat_round")
    return out, alpha


def gat_round_backward(grad_out, dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
                       ins_value=None, keep_scale=None, *, npg, epg,
                       negative_slope=0.2, shift="graph", shift_max=None):
    """The round's vjp -> (d_xw, d_alpha_l, d_alpha_r, d_alpha_e,
    d_ins_value or None), as :func:`gat_round_backward_reference` documents.

    CUDA tensors launch ``csrc/gat_round_backward.cu`` (counted on the card,
    ``cuda_lib.launch_counts``); CPU tensors run the plain version."""
    if xw.device.type == "cpu":
        return gat_round_backward_reference(
            grad_out, dl, sl, mask, alpha_l, alpha_r, alpha_e, xw, ins_value,
            keep_scale, npg=npg, epg=epg, negative_slope=negative_slope,
            shift=shift, shift_max=shift_max)
    return _backward_launch(
        grad_out, dl, sl, mask, alpha_l, alpha_r, alpha_e, xw, ins_value,
        keep_scale, npg=npg, epg=epg, negative_slope=negative_slope,
        shift=shift, shift_max=shift_max)[0]


def _backward_launch(grad_out, dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
                     ins_value=None, keep_scale=None, *, npg, epg,
                     negative_slope=0.2, shift="graph", shift_max=None):
    """:func:`gat_round_backward`'s kernel launch on CUDA tensors, with its
    arguments -> (the gradients, the launch's (graph, head) work counter,
    which holds the number of units handed out once the launch has run)."""
    _check_cuda_inputs(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
                       ins_value, keep_scale, npg, epg, shift, shift_max)
    B = dl.shape[0]
    N, H, C = xw.shape
    dev = xw.device
    check_tensor("grad_out", grad_out, (N, C), (xw.dtype,), dev)
    lib = cuda_lib.bind("gat_round_backward", _BACKWARD)
    code = DTYPE_CODES[xw.dtype]
    _smem_check("gat_round_backward",
                lambda: lib.gat_round_backward_smem_bytes(
                    npg, epg, H, C, code),
                (npg, epg, H, C, code), dev)
    d_xw = torch.empty_like(xw)
    d_al = torch.empty((N, H), dtype=torch.float32, device=dev)
    d_ar = torch.empty_like(d_al)
    d_ae = torch.empty((B, epg, H), dtype=torch.float32, device=dev)
    d_ins = None if ins_value is None else torch.empty_like(ins_value)
    # the kernel's (graph, head) work counter, which the library zeroes on
    # the stream
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    args = (code, dl.data_ptr(), sl.data_ptr(), mask.data_ptr(),
            alpha_l.data_ptr(), alpha_r.data_ptr(), alpha_e.data_ptr(),
            _ptr(keep_scale), _ptr(shift_max), xw.data_ptr(),
            _ptr(ins_value), grad_out.data_ptr(), d_xw.data_ptr(), d_al.data_ptr(),
            d_ar.data_ptr(), d_ae.data_ptr(), _ptr(d_ins),
            counter.data_ptr(),
            cuda_lib.launch_word("gat_round_backward", dev).data_ptr(), B,
            npg, epg, H, C, float(negative_slope), int(shift == "graph"))
    cuda_lib.launch(lib.gat_round_backward_launch, args, dev,
                    "gat_round_backward")
    return (d_xw, d_al, d_ar, d_ae, d_ins), counter


class GATRoundFunction(torch.autograd.Function):
    """The round with its hand-written backward. Only the inputs are saved:
    the backward recomputes the logits and the softmax terms from them
    (no bytes beyond the inputs, which autograd would keep anyway). The
    attention output, when asked for, carries no gradient."""

    @staticmethod
    def forward(ctx, dl, sl, mask, alpha_l, alpha_r, alpha_e, xw, ins_value,
                keep_scale, npg, epg, negative_slope, shift, return_alpha,
                shift_max):
        out, alpha = _forward(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
                              ins_value, keep_scale, npg, epg,
                              negative_slope, shift, return_alpha, shift_max)
        ctx.save_for_backward(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
                              ins_value, keep_scale, shift_max)
        ctx.widths = (npg, epg, negative_slope, shift)
        if alpha is None:
            return out
        ctx.mark_non_differentiable(alpha)
        return out, alpha

    @staticmethod
    def backward(ctx, grad_out, *_):
        npg, epg, slope, shift = ctx.widths
        dl, sl, mask, al, ar, ae, xw, ins, keep, gmax = ctx.saved_tensors
        d_xw, d_al, d_ar, d_ae, d_ins = gat_round_backward(
            grad_out.contiguous(), dl, sl, mask, al, ar, ae, xw, ins, keep,
            npg=npg, epg=epg, negative_slope=slope, shift=shift,
            shift_max=gmax)
        return (None, None, None, d_al, d_ar, d_ae, d_xw, d_ins,
                None, None, None, None, None, None, None)


def gat_round(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw, ins_value=None,
              *, npg, epg, negative_slope=0.2, shift="graph", keep_scale=None,
              return_alpha=False, shift_max=None):
    """One fused GAT round -> [B*npg, C] in xw's dtype (see module doc);
    with ``return_alpha`` also the attention [B*epg, H] (no gradient).

    CUDA tensors launch the kernel (counted on the card,
    ``cuda_lib.launch_counts``); CPU tensors run :func:`gat_round_reference`.
    When a float input requires grad, the call goes through
    :class:`GATRoundFunction`, whose backward is the backward kernel (or its
    plain version on the CPU). ``alpha_e`` is cast to float32 here;
    ``ins_value`` must share xw's dtype; ``keep_scale`` [B, epg, H] f32 is
    the attention dropout scale; ``shift_max`` [B, H] f32 the 'graph' shift
    given (an edge-sharded round's, :func:`graph_logit_max`). Edges must be
    in the dense packing's order (module doc).
    """
    alpha_e = alpha_e.float().contiguous()
    args = (dl, sl, mask, alpha_l, alpha_r, alpha_e, xw, ins_value,
            keep_scale, npg, epg, negative_slope, shift, return_alpha,
            shift_max)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (alpha_l, alpha_r, alpha_e, xw, ins_value)):
        return GATRoundFunction.apply(*args)
    out, alpha = _forward(*args)
    return (out, alpha) if return_alpha else out

