"""Collectives of the multi-device paths (port of
``graphvqa_tpu/parallel/collectives.py``), over ``torch.distributed``.

Each takes a process group from :class:`~graphvqa_tpu_torch.parallel.mesh.Mesh`;
a group of None is this process alone, and the collective is the identity.

The collectives of a train or eval step (:func:`all_reduce_`, :func:`pmax`,
:class:`AssembleRows`) may run inside a CUDA graph's capture
(``train/graphs.py``). Over NCCL they are captured into the graph. Through
gloo, which reduces on the host, each is a host call of the step, and in a
capture a cut: the graph before it writes the step's own buffer for the
call, the host reduces that buffer in place between two replayed graphs,
and the graph after it reads it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from graphvqa_tpu_torch.train import graphs


def psum_scalars(metrics: Dict[str, torch.Tensor],
                 group: Optional[object]) -> Dict[str, torch.Tensor]:
    """Sum each scalar over ``group`` in one all-reduce (the reference's
    ``reduce_dict``), in float64 so that counts stay exact."""
    if group is None:
        return dict(metrics)
    keys = list(metrics)
    flat = torch.stack([torch.as_tensor(metrics[k]).to(torch.float64)
                        .reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    return dict(zip(keys, flat.unbind()))


def all_gather_host(obj: Any, group: Optional[object] = None) -> List[Any]:
    """Every rank's picklable ``obj`` of ``group``, in rank order
    (``[obj]`` alone). ``group`` None gathers over the whole process group
    when one is initialized."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_reduce_(t: torch.Tensor, group: object,
                op=dist.ReduceOp.SUM) -> None:
    """``t`` all-reduced over ``group`` in place: inside the step's graph
    over NCCL, else a host call (module doc). ``t`` lies outside the
    graphs' pool and is the same tensor at every call of the step (as
    ``data_parallel.StepReduce.flat`` is)."""
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(t, op=op, group=group)
    else:
        graphs.host_call(lambda: dist.all_reduce(t, op=op, group=group))


def _reduced(x: torch.Tensor, group: object, op) -> torch.Tensor:
    """A copy of ``x`` all-reduced over ``group``: through the host, in the
    step's own buffer for the call (``train/graphs.py:host_buffer``), and
    a copy of that handed on, since the buffer is the step's."""
    if dist.get_backend(group) == "nccl" or not graphs.stepping():
        out = x.clone()
        dist.all_reduce(out, op=op, group=group)
        return out
    buf = graphs.host_buffer(x)
    all_reduce_(buf, group, op)
    return buf.clone()


def pmax(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The element-wise max over ``group`` (no gradient); ``x`` for None."""
    if group is None:
        return x
    return _reduced(x.detach(), group, dist.ReduceOp.MAX)


class AssembleRows(torch.autograd.Function):
    """Sum over ``group`` in both directions.

    Forward: the edge ranks' destination rows are disjoint (each rank's
    edges point at the destinations it owns, and the other rows are 0), so
    the sum assembles the replicated node rows exactly. Backward: each rank
    holds a share of the cotangent, and the shares sum to the whole one, so
    each rank hands its rows the sum. The train step scales every rank's
    loss by 1/K (K ranks in ``group``), which makes every gradient a share
    that sums over the edge group to the single-device gradient
    (``parallel/data_parallel.py``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return _reduced(grad, ctx.group, dist.ReduceOp.SUM), None


def assemble_rows(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """:class:`AssembleRows` over ``group``; the identity for None."""
    return x if group is None else AssembleRows.apply(x, group)
