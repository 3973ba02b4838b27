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

A step makes one collective: the gradients, the running statistics and the
step's metrics go through one all-reduce in one float32 buffer
(:class:`StepReduce`), as JAX's ``shard_map`` step reduces them inside one
program. On the card the step replays CUDA graphs per batch shape, as
``make_train_step`` does (``train/graphs.py``), the port's counterpart of
JAX's jitted DP and data x edge steps. Over NCCL the step is one graph with
every collective inside it, JAX's single dispatch. Through gloo each
collective is a cut between two graphs: the DP step is graph A (forward,
backward, the buffer packed), the all-reduce on the host, graph B (the
buffer unpacked, Adam, the statistics and metrics written); with an edge
axis the forward's and the backward's collectives
(``parallel/edge_sharded.py``) cut it too, into 19 graphs at
gat_config()'s five GAT rounds.

With the program's tracing on (``core/profiling.py``) the step stamps the
device segment ``allreduce`` around the all-reduce: over gloo the card's
time from the end of graph A to the start of graph B, the exposed
reduction; over NCCL the collective's kernels. The metrics and the buffer's
packing before it, and its unpacking with Adam after it, go to
``optimizer``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from graphvqa_tpu_torch.config import Config
from graphvqa_tpu_torch.core import profiling
from graphvqa_tpu_torch.core.graph import QABatch
from graphvqa_tpu_torch.models.pipeline import PipelineModel
from graphvqa_tpu_torch.parallel.collectives import all_reduce_
from graphvqa_tpu_torch.parallel.mesh import Mesh
from graphvqa_tpu_torch.train import loop
from graphvqa_tpu_torch.train.loop import forward_backward, multi_step
from graphvqa_tpu_torch.train.metrics import SCAN_COUNT_KEYS
from graphvqa_tpu_torch.train.train_state import TrainState


def running_stats(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The BatchNorm running statistics (mean and variance) by name."""
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


class StepReduce:
    """A step's one all-reduce over the mesh's world group. :meth:`pack`
    writes every parameter's gradient (a missing one as zeros), every
    running statistic and the step's metrics into one float32 buffer,
    :meth:`all_reduce` sums it, :meth:`unpack` reads it back:

      * the gradients divided by the data ranks (the edge ranks' shares of
        one data rank sum to its gradient);
      * the running statistics divided by every rank, written in place;
      * ``edge_count`` summed over every rank (each edge rank counts its own
        edges), the other counts (``SCAN_COUNT_KEYS``) divided by the edge
        ranks (alike on them), the rest divided by every rank; each cast
        back to its own dtype. float32 keeps counts exact below 2**24.

    The buffer is made at the first pack, outside any capture (a step's
    first call at a batch shape is its eager warm-up), and stays the same
    tensor: a CUDA graph holds its address, and it lies outside the graphs'
    pool. A world group of None is this process alone: the all-reduce is
    the identity."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh):
        self.mesh = mesh
        self.params = list(model.named_parameters())
        self.stats = list(running_stats(model).values())
        self.n_grad = sum(p.numel() for _, p in self.params)
        self.n_stat = sum(s.numel() for s in self.stats)
        self.flat: Optional[torch.Tensor] = None
        self.metric_dtypes: Dict[str, torch.dtype] = {}

    @torch.no_grad()
    def pack(self, metrics: Dict[str, torch.Tensor]) -> None:
        if self.flat is None:
            self.metric_dtypes = {k: v.dtype for k, v in metrics.items()}
            self.flat = torch.empty(
                self.n_grad + self.n_stat + len(metrics),
                dtype=torch.float32, device=self.params[0][1].device)
        elif metrics.keys() != self.metric_dtypes.keys():
            raise ValueError(f"the step's metrics {sorted(metrics)} differ "
                             f"from its first step's "
                             f"{sorted(self.metric_dtypes)}")
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for _, p in self.params]
        torch.cat([t.reshape(-1).float() for t in grads + self.stats]
                  + [metrics[k].reshape(1).float()
                     for k in self.metric_dtypes], out=self.flat)

    def all_reduce(self) -> None:
        if self.mesh.world_group is not None:
            all_reduce_(self.flat, self.mesh.world_group)

    @torch.no_grad()
    def unpack(self):
        """-> (reduced gradient by parameter name, a view of the buffer;
        the reduced metrics); the running statistics are written."""
        mesh, flat = self.mesh, self.flat
        flat[:self.n_grad].div_(mesh.data)
        flat[self.n_grad:self.n_grad + self.n_stat].div_(mesh.size)
        grads, at = {}, 0
        for n, p in self.params:
            grads[n] = flat[at:at + p.numel()].view_as(p)
            at += p.numel()
        for s in self.stats:
            s.copy_(flat[at:at + s.numel()].view_as(s))
            at += s.numel()
        metrics = {}
        for k, dtype in self.metric_dtypes.items():
            v = flat[at]
            if k in SCAN_COUNT_KEYS and k != "edge_count":
                v = v / mesh.edge
            elif k not in SCAN_COUNT_KEYS:
                v = v / mesh.size
            metrics[k] = v.to(dtype)
            at += 1
        return grads, metrics


def make_dp_train_step(model: PipelineModel, cfg: Config, mesh: Mesh,
                       steps_per_dispatch: int = 1,
                       capture: bool = True) -> Callable:
    """``train_step(state, batch, generator, ctx_generator=None)`` of this
    rank, with make_train_step's signature and metrics; the metrics come
    back reduced over the mesh. Seed the generators by the data rank
    (``parallel/mesh.py:data_seed``), never by the global rank: the edge
    ranks of a data index must draw alike. ``steps_per_dispatch`` K > 1
    takes a list of K batches and runs K steps in order (K replays on the
    card). On the card each step replays its batch shape's graphs (module
    doc; ``capture=False`` keeps the eager step, the graphs are
    ``train_step.graphs``). A replayed step's metrics and ``.grad`` are its
    graphs' outputs, which the next step overwrites, as
    ``make_train_step``'s are."""
    loss_scale = 1.0 / mesh.edge
    reduce = StepReduce(model, mesh)
    graphs = loop._graphs(model, capture)

    def body(state: TrainState, batch: QABatch, generator, ctx_generator):
        """Forward, backward, the buffer packed, reduced and unpacked, Adam
        -> (this rank's own gradients, the reduced metrics)."""
        metrics = forward_backward(model, cfg, batch, generator,
                                   ctx_generator, loss_scale=loss_scale)
        own = {n: p.grad for n, p in model.named_parameters()}
        dev = batch.questions.device
        reduce.pack(metrics)
        profiling.stamp("optimizer", dev)
        reduce.all_reduce()
        profiling.stamp("allreduce", dev)
        grads, metrics = reduce.unpack()
        state.update(grads)
        profiling.stamp("optimizer", dev)
        return own, metrics

    def train_step(state: TrainState, batch: QABatch,
                   generator: torch.Generator,
                   ctx_generator: Optional[torch.Generator] = None):
        if mesh.edge > 1 and batch.graphs.edge_group is None:
            raise ValueError("an edge axis needs batches from "
                             "edge_sharded.prepare_dp_edge_batch")
        lr = state.current_lr()
        state.prepare()
        if graphs is None:
            _, metrics = body(state, batch, generator, ctx_generator)
        else:
            own, metrics = graphs(
                lambda b: body(state, b, generator, ctx_generator), batch,
                (generator, ctx_generator),
                bind=(state, state.opt_state, state.opt_state["count"],
                      state.lr_tensor))
            # this rank's own gradient, before the reduce (module doc)
            for n, p in model.named_parameters():
                p.grad = own[n]
        state.step += 1
        return state, dict(metrics, lr=lr)

    train_step.graphs = graphs
    if steps_per_dispatch <= 1:
        return train_step
    run = multi_step(train_step, steps_per_dispatch)
    run.graphs = graphs
    return run
