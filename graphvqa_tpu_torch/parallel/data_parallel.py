"""Data-parallel train step (port of ``graphvqa_tpu/parallel/data_parallel.py``).

Every rank runs the single-device step's forward and backward
(``train/loop.py:forward_backward``) on its own batch. Then one all-reduce
over the world carries, in one float32 buffer, every parameter's gradient
and every BatchNorm running statistic, and each rank takes the same Adam
step (``TrainState.apply_gradients``). As in the JAX step:

  * the gradients are the mean over the data ranks (``pmean``), a parameter
    that got none counting as a zero gradient, so that Adam still steps its
    moments (``DistributedDataParallel`` would raise on it);
  * the running statistics are the mean over the data ranks too, not rank
    0's copy (DDP's ``broadcast_buffers``);
  * the loss and its parts are meaned, the counts summed.

With an edge axis of K ranks (``parallel/edge_sharded.py``) each rank scales
its loss by 1/K, so that its gradient is a share and the K shares of an edge
group sum to the data rank's gradient; the same one all-reduce then sums
them. After a step each parameter's ``.grad`` still holds this rank's own
gradient (before the reduce); the reduced one is what Adam took.

The JAX package stacks the data ranks' batches into one array, and so
aligns their shapes first (``align_dense_group``); here every rank holds its
own batch at its own shapes, so nothing is aligned (``core/packing.py:
repack_dense`` is kept as the layout tool it calls).

The step stays eager, with the edge-sharded one: its all-reduce (and the
edge path's assemblies) go through gloo, which a CUDA graph cannot hold, so
it calls ``forward_backward`` and ``apply_gradients`` directly and never
``make_train_step``'s graphs. On cards of their own, NCCL's collectives
could be captured (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from graphvqa_tpu_torch.config import Config
from graphvqa_tpu_torch.core.graph import QABatch
from graphvqa_tpu_torch.models.pipeline import PipelineModel
from graphvqa_tpu_torch.parallel.collectives import psum_scalars
from graphvqa_tpu_torch.parallel.mesh import Mesh
from graphvqa_tpu_torch.train.loop import forward_backward, multi_step
from graphvqa_tpu_torch.train.metrics import SCAN_COUNT_KEYS
from graphvqa_tpu_torch.train.train_state import TrainState


def running_stats(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The BatchNorm running statistics (mean and variance) by name."""
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def reduce_gradients(model: torch.nn.Module, mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient summed over the world and divided by the
    data ranks, a missing one as zeros; the running statistics replaced by
    their mean over the world (in place). One all-reduce; ``.grad`` is left
    as it is."""
    params = list(model.named_parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for _, p in params]
    if mesh.world_group is None:
        return {n: g for (n, _), g in zip(params, grads)}
    stats = list(running_stats(model).values())
    flat = torch.cat([t.reshape(-1).float() for t in grads + stats])
    dist.all_reduce(flat, group=mesh.world_group)
    n_grad = sum(g.numel() for g in grads)
    flat[:n_grad] /= mesh.data
    flat[n_grad:] /= mesh.size
    out, at = {}, 0
    for (n, p), g in zip(params, grads):
        out[n] = flat[at:at + g.numel()].view_as(p)
        at += g.numel()
    with torch.no_grad():
        for s in stats:
            s.copy_(flat[at:at + s.numel()].view_as(s))
            at += s.numel()
    return out


def reduce_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh
                   ) -> Dict[str, torch.Tensor]:
    """The step's metrics over the mesh in one all-reduce: counts summed
    over the data ranks, the rest meaned, and ``edge_count`` summed over
    every rank (each edge rank counts its own edges)."""
    if mesh.world_group is None:
        return dict(metrics)
    summed = psum_scalars(metrics, mesh.world_group)
    out = {}
    for k, v in summed.items():
        if k == "edge_count":
            pass
        elif k in SCAN_COUNT_KEYS:     # alike on the edge ranks
            v = v / mesh.edge
        else:
            v = v / mesh.size
        out[k] = v.to(metrics[k].dtype)
    return out


def make_dp_train_step(model: PipelineModel, cfg: Config, mesh: Mesh,
                       steps_per_dispatch: int = 1) -> Callable:
    """``train_step(state, batch, generator, ctx_generator=None)`` of this
    rank, with make_train_step's signature and metrics; the metrics come
    back reduced over the mesh. Seed the generators by the data rank
    (``parallel/mesh.py:data_seed``), never by the global rank: the edge
    ranks of a data index must draw alike. ``steps_per_dispatch`` K > 1
    takes a list of K batches and runs K steps in order."""
    loss_scale = 1.0 / mesh.edge

    def train_step(state: TrainState, batch: QABatch,
                   generator: torch.Generator,
                   ctx_generator: Optional[torch.Generator] = None):
        if mesh.edge > 1 and batch.graphs.edge_group is None:
            raise ValueError("an edge axis needs batches from "
                             "edge_sharded.prepare_dp_edge_batch")
        lr = state.current_lr()
        metrics = forward_backward(model, cfg, batch, generator,
                                   ctx_generator, loss_scale=loss_scale)
        state.apply_gradients(reduce_gradients(model, mesh))
        metrics = reduce_metrics(metrics, mesh)
        metrics["lr"] = lr
        return state, metrics

    if steps_per_dispatch <= 1:
        return train_step
    return multi_step(train_step, steps_per_dispatch)
