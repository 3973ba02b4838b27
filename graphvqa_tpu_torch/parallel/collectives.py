"""Collectives of the multi-device paths (port of
``graphvqa_tpu/parallel/collectives.py``), over ``torch.distributed``.

Each takes a process group from :class:`~graphvqa_tpu_torch.parallel.mesh.Mesh`;
a group of None is this process alone, and the collective is the identity.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist


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


def pmax(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The element-wise max over ``group`` (no gradient); ``x`` for None."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


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
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def assemble_rows(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """:class:`AssembleRows` over ``group``; the identity for None."""
    return x if group is None else AssembleRows.apply(x, group)
