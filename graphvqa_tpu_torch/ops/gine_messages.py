"""The GINE round's messages and their per-destination sum: a hand-written
CUDA kernel pair and its plain twin.

Replaces no TPU kernel: the JAX package's ``GINESeq`` is XLA ops. It was
added because the composite (``nn/gnn.py:GINESeq`` through
``ops/dense.py:dense_gather_src`` and ``dense_aggregate_edges``) built
several [E, C + D] rows a round, with a dozen memory-bound kernels, and took
5.5-6.2 ms of a 45 ms train step at B=200 (segment ``engine_messages``,
``PERF.md`` §5), with its backward's bf16 atomic ``index_add_`` on top.

:func:`gine_messages` computes, on the dense layout, what ``GINESeq`` feeds
each round's MLP::

    z = x_cat + M(sum over real edges e -> v of
                  relu(x_cat[src_e] + edge_cat[e]))

with ``x_cat = [h ; ins_g]``, ``edge_cat = [edge_attr ; ins_g]``, the sum in
float32 rounded once to the messages' dtype ``M`` (the promotion of h's,
edge_attr's and ins's dtypes, as ``torch.cat`` and the add promote them),
then added to ``x_cat`` in ``M``. Every rounding point is the composite's;
only the order of the float32 additions differs.

Bound (H100, 3.35 TB/s): bytes. At B=200, npg=64, epg=256, C=300, D=512 in
bf16 a round's forward needs h [12,800, 300] (7.7 MB), edge_attr [51,200,
300] (30.7 MB) and ins read once and z [12,800, 812] (20.8 MB) written once:
<= 59 MB, ~18 us; the backward reads dz, h and edge_attr and writes dh,
d_edge_attr and d_ins: ~98 MB, ~29 us. What the design does about it:

1. The ins half needs no edge rows. For a real edge the message's last D
   columns are ``relu(ins_g + ins_g)``, exact in M, so the destination's sum
   there is ``indeg(v) * relu(2 ins_g)``: exact in float32 for bf16 values
   (8 significant bits times a count below 2^16), so bit for bit the
   composite's sum of indeg(v) equal values. Only the first C columns are
   gathered and summed over edges; no [E, C + D] tensor exists, forward or
   backward.
2. The forward needs no atomics: each graph's real edges come first, sorted
   by destination (``core/packing.py:pack_graphs_dense``), so a
   destination's in-edges are one run. A block per (graph, column tile)
   stages the graph's h tile in shared memory, walks each destination's run
   in edge order and keeps the float32 sum in registers; padded edges are
   never read. Two runs give the same bits.
3. The backward recomputes ``pre = M(h[src] + edge_attr)`` per real edge:
   ``d_edge_attr[e] = dz[dst_e, :C] * 1[pre > 0]`` (0 at 0, as PyTorch's
   ``threshold_backward``; padded rows 0), ``dh[u] = dz[u, :C] + sum over
   edges leaving u of d_edge_attr[e]`` (a block per (graph, column tile)
   stages the graph's dz tile, orders the edges by source in shared memory
   with a stable counting sort and sums each source's run in float32), and
   ``d_ins_g = sum_v dz[v, C:] + 2 * 1[ins_g > 0] * sum_v indeg(v) dz[v, C:]``
   over all npg rows (padded rows receive the broadcast). No atomics on
   floats, so it too is deterministic.

On a CPU tensor :func:`gine_messages` runs :func:`gine_messages_reference`
(and :func:`gine_messages_backward_reference` in autograd's backward), the
same function in index ops, which raises on edges in another order. On a
CUDA tensor it launches ``csrc/gine_messages.cu`` (and
``csrc/gine_messages_backward.cu``) or raises; the kernels' device assert
stops them on edges in another order. Both build with the port's other
kernels (``ops/cuda_lib.py``), launch on the current stream and set their
shared-memory attribute on an eager launch only, so the step graphs
(``train/graphs.py``) replay them. Each launch counts itself on the card
(``cuda_lib.launch_counts``).
"""
from __future__ import annotations

import ctypes

import torch

from graphvqa_tpu_torch.ops import cuda_lib
from graphvqa_tpu_torch.ops.cuda_lib import DTYPE_CODES, check_tensor
from graphvqa_tpu_torch.ops.dense import dense_edges, edges_dst_sorted

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# each direction's launcher: {function: (argtypes, restype)}
_FORWARD = {"gine_messages_launch": ([_ci] * 3 + [_vp] * 8 + [_ci] * 5
                                     + [_vp], _ci)}
_BACKWARD = {"gine_messages_backward_launch": ([_ci] * 3 + [_vp] * 11
                                               + [_ci] * 5 + [_vp], _ci)}


def messages_dtype(h: torch.Tensor, ins: torch.Tensor,
                   edge_attr: torch.Tensor) -> torch.dtype:
    """The dtype of the composite's messages and of z: ``[h ; ins]`` and
    ``[edge_attr ; ins]`` promoted, then their sum promoted."""
    p = torch.promote_types
    return p(p(h.dtype, ins.dtype), p(edge_attr.dtype, ins.dtype))


def _check_order(dl, sl, mask, npg):
    if not edges_dst_sorted(dl, sl, mask, npg):
        raise ValueError("gine_messages needs each graph's real edges first "
                         "and sorted by destination, padding last")


def gine_messages_reference(h, ins, edge_attr, dl, sl, mask, *, npg):
    """Plain twin of the forward kernel.

    h [B*npg, C], ins [B, D], edge_attr [B*epg, C], dl/sl [B, epg] local
    indices, mask [B, epg] (true or > 0 on real edges) -> z [B*npg, C + D]
    in :func:`messages_dtype`. Differentiable (autograd through it is the
    closed form's arithmetic in another order)."""
    _check_order(dl, sl, mask, npg)
    B = dl.shape[0]
    N, C = h.shape
    dt = messages_dtype(h, ins, edge_attr)
    real, src, dst = dense_edges(dl, sl, mask, npg)
    pre = h.index_select(0, src).to(dt) + edge_attr.to(dt)
    msg = torch.where(real[:, None], torch.relu(pre), 0.0).float()
    acc = torch.zeros(N, C, device=h.device).index_add(0, dst, msg)
    indeg = torch.zeros(N, device=h.device).index_add(0, dst, real.float())
    insm = ins.to(dt)
    r = torch.relu(insm + insm).float()
    ins_sum = (indeg.reshape(B, npg, 1) * r[:, None, :]).reshape(N, -1)
    nodes_ins = insm[:, None, :].expand(B, npg, -1).reshape(N, -1)
    x_cat = torch.cat([h.to(dt), nodes_ins], dim=-1)
    return x_cat + torch.cat([acc, ins_sum], dim=-1).to(dt)


def gine_messages_backward_reference(dz, h, ins, edge_attr, dl, sl, mask, *,
                                     npg):
    """Plain twin of the backward kernel: the vjp of
    :func:`gine_messages_reference` for dz [B*npg, C + D] in closed form
    (design note 3 of the module doc), float32 sums -> (dh in h's dtype,
    d_edge_attr in edge_attr's, d_ins in ins's)."""
    B = dl.shape[0]
    N, C = h.shape
    D = ins.shape[-1]
    dt = messages_dtype(h, ins, edge_attr)
    with torch.no_grad():
        real, src, dst = dense_edges(dl, sl, mask, npg)
        pre = h.index_select(0, src).to(dt) + edge_attr.to(dt)
        dzc = dz[:, :C]
        g = torch.where(real[:, None] & (pre > 0), dzc.index_select(0, dst),
                        0.0)
        acc = torch.zeros(N, C, device=h.device).index_add(0, src, g.float())
        dh = (dzc.float() + acc).to(h.dtype)
        indeg = torch.zeros(N, device=h.device).index_add(0, dst, real.float())
        dzi = dz[:, C:].float().reshape(B, npg, D)
        on = torch.where(ins.to(dt) > 0, 2.0, 0.0)
        d_ins = dzi.sum(1) + on * (indeg.reshape(B, npg, 1) * dzi).sum(1)
    return dh, g.to(edge_attr.dtype), d_ins.to(ins.dtype)


def _check_cuda_inputs(h, ins, edge_attr, dl, sl, mask, npg):
    """The kernels' contract; ins must already be in the messages' dtype."""
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"gine_messages runs on cuda or cpu, not {dev}")
    B, epg = dl.shape
    C, D = h.shape[-1], ins.shape[-1]
    floats = tuple(DTYPE_CODES)
    check_tensor("h", h, (B * npg, C), floats, dev)
    check_tensor("edge_attr", edge_attr, (B * epg, C), floats, dev)
    check_tensor("ins", ins, (B, D), (messages_dtype(h, ins, edge_attr),),
                 dev)
    check_tensor("dl", dl, (B, epg), (torch.int32,), dev)
    check_tensor("sl", sl, (B, epg), (torch.int32,), dev)
    check_tensor("mask", mask, (B, epg), (torch.bool,), dev)
    if min(B, npg, epg, C, D) < 1:
        raise ValueError(f"gine_messages needs B, npg, epg, C, D >= 1, got "
                         f"{(B, npg, epg, C, D)}")


def _codes(h, ins, edge_attr):
    return (DTYPE_CODES[h.dtype], DTYPE_CODES[edge_attr.dtype],
            DTYPE_CODES[ins.dtype])


def _forward(h, ins, edge_attr, dl, sl, mask, npg):
    """z: the kernel on CUDA tensors (ins in the messages' dtype), the plain
    version on CPU tensors."""
    if h.device.type == "cpu":
        return gine_messages_reference(h, ins, edge_attr, dl, sl, mask,
                                       npg=npg)
    _check_cuda_inputs(h, ins, edge_attr, dl, sl, mask, npg)
    B, epg = dl.shape
    C, D = h.shape[-1], ins.shape[-1]
    dev = h.device
    z = torch.empty((B * npg, C + D), dtype=ins.dtype, device=dev)
    args = (*_codes(h, ins, edge_attr), dl.data_ptr(), sl.data_ptr(),
            mask.data_ptr(), h.data_ptr(), ins.data_ptr(),
            edge_attr.data_ptr(), z.data_ptr(),
            cuda_lib.launch_word("gine_messages", dev).data_ptr(),
            B, npg, epg, C, D)
    cuda_lib.launch(cuda_lib.bind("gine_messages", _FORWARD)
                    .gine_messages_launch, args, dev, "gine_messages")
    return z


def gine_messages_backward(dz, h, ins, edge_attr, dl, sl, mask, *, npg):
    """The vjp -> (dh, d_edge_attr, d_ins), as
    :func:`gine_messages_backward_reference` documents: the backward kernel
    on CUDA tensors (ins and dz in the messages' dtype; counted on the card,
    ``cuda_lib.launch_counts``), the plain version on CPU tensors."""
    if h.device.type == "cpu":
        return gine_messages_backward_reference(dz, h, ins, edge_attr, dl,
                                                sl, mask, npg=npg)
    _check_cuda_inputs(h, ins, edge_attr, dl, sl, mask, npg)
    B, epg = dl.shape
    C, D = h.shape[-1], ins.shape[-1]
    dev = h.device
    check_tensor("dz", dz, (B * npg, C + D), (ins.dtype,), dev)
    dh = torch.empty_like(h)
    d_edge = torch.empty_like(edge_attr)
    d_ins = torch.empty_like(ins)
    args = (*_codes(h, ins, edge_attr), dl.data_ptr(), sl.data_ptr(),
            mask.data_ptr(), h.data_ptr(), ins.data_ptr(),
            edge_attr.data_ptr(), dz.data_ptr(), dh.data_ptr(),
            d_edge.data_ptr(), d_ins.data_ptr(),
            cuda_lib.launch_word("gine_messages_backward", dev).data_ptr(),
            B, npg, epg, C, D)
    cuda_lib.launch(cuda_lib.bind("gine_messages_backward", _BACKWARD)
                    .gine_messages_backward_launch, args, dev,
                    "gine_messages_backward")
    return dh, d_edge, d_ins


class GINEMessagesFunction(torch.autograd.Function):
    """The pair in autograd. Saves only the inputs (h, ins, edge_attr and
    the indices): the backward recomputes each edge's sign."""

    @staticmethod
    def forward(ctx, h, ins, edge_attr, dl, sl, mask, npg):
        z = _forward(h, ins, edge_attr, dl, sl, mask, npg)
        ctx.save_for_backward(h, ins, edge_attr, dl, sl, mask)
        ctx.npg = npg
        return z

    @staticmethod
    def backward(ctx, dz):
        h, ins, edge_attr, dl, sl, mask = ctx.saved_tensors
        dh, d_edge, d_ins = gine_messages_backward(
            dz.contiguous(), h, ins, edge_attr, dl, sl, mask, npg=ctx.npg)
        return dh, d_ins, d_edge, None, None, None, None


def gine_messages(h, ins, edge_attr, dl, sl, mask, *, npg):
    """One GINE round's ``x_cat + aggr`` on the dense layout -> [B*npg,
    C + D] in :func:`messages_dtype` (module doc).

    h [B*npg, C], ins [B, D] (the round's instruction vectors), edge_attr
    [B*epg, C], dl/sl [B, epg] int32 local indices
    (``ops/dense.py:dense_local_indices``), mask [B, epg] bool, each graph's
    real edges first and sorted by destination. CUDA tensors launch the
    kernels (through :class:`GINEMessagesFunction` when autograd needs the
    backward); CPU tensors run the plain versions."""
    # the round's ins is a strided slice of the instruction vectors
    ins = ins.to(messages_dtype(h, ins, edge_attr))
    args = (h.contiguous(), ins.contiguous(), edge_attr.contiguous(), dl, sl,
            mask, npg)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:3]):
        return GINEMessagesFunction.apply(*args)
    return _forward(*args)
