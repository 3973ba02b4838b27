"""Process groups of the multi-device paths (port of
``graphvqa_tpu/parallel/mesh.py``).

One process per rank, as under ``python -m torch.distributed.run``
(torchrun). The ranks are laid out as a (data, edge) grid, as ``make_mesh``
lays devices in the JAX package: rank = d * edge + e.

  * ``data`` shards the batch: every data rank trains on its own batches,
    and the gradients are averaged over it (the DDP of the reference);
  * ``edge`` shards each graph's edges by destination ownership
    (``parallel/edge_sharded.py``): the ranks of one data index share a
    batch and hold one share of its edges each.

:func:`maybe_init_distributed` joins the process group when ``RANK`` and
``WORLD_SIZE`` are set (the reference's ``init_distributed_mode``); the
backend follows the device: ``nccl`` on a GPU, ``gloo`` on the CPU.
``gloo`` on a GPU lets several ranks share one card (gloo reduces CUDA
tensors through the host); ``nccl`` refuses that, so asking for more ranks
on a host than it has cards raises instead of oversubscribing.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from graphvqa_tpu_torch.core.device import DeviceLike, resolve_device


def maybe_init_distributed(device: DeviceLike = None,
                           backend: Optional[str] = None) -> torch.device:
    """Join the process group described by the environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) when
    ``RANK`` and ``WORLD_SIZE`` are set; return this rank's device: on a GPU
    ``cuda:(LOCAL_RANK % device_count)``. ``backend`` None picks by device;
    'gloo' on a GPU is the explicit choice of ranks sharing cards."""
    dev = resolve_device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return dev
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1))
        if backend == "nccl" and cards < local_world:
            raise RuntimeError(
                f"{local_world} ranks on this host but {cards} CUDA "
                f"device(s): NCCL gives each rank a card of its own; run at "
                f"most {cards} ranks per host, or pass --dist-backend gloo "
                f"to let ranks share cards")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend=backend)
    return dev


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, edge) grid and its process groups:
    ``world`` (every rank), ``data_group`` (the ranks of this edge index,
    over which gradients and meters reduce) and ``edge_group`` (the ranks of
    this data index, which share one batch). A group is None where it would
    hold this rank alone."""
    data: int
    edge: int
    rank: int
    world_group: Optional[object] = None
    data_group: Optional[object] = None
    edge_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.data * self.edge

    @property
    def data_rank(self) -> int:
        return self.rank // self.edge

    @property
    def edge_rank(self) -> int:
        return self.rank % self.edge

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that logs and writes checkpoints and dumps."""
        return self.rank == 0


def make_mesh(data: Optional[int] = None, edge: int = 1) -> Mesh:
    """The (data, edge) grid over the process group (one process when none
    is initialized). ``data`` None takes world_size // edge. Every rank
    must call this, in the same order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None:
        if world % edge:
            raise ValueError(f"world size {world} is not a multiple of "
                             f"edge={edge}")
        data = world // edge
    if data * edge != world:
        raise ValueError(f"mesh {data}x{edge} != world size {world}")
    mesh = Mesh(data=data, edge=edge, rank=rank)
    if world == 1:
        return mesh
    mesh.world_group = dist.group.WORLD
    # dist.new_group is collective: every rank creates every group
    for e in range(edge):
        g = dist.new_group([d * edge + e for d in range(data)])
        if data > 1 and e == mesh.edge_rank:
            mesh.data_group = g
    for d in range(data):
        g = dist.new_group([d * edge + e for e in range(edge)])
        if edge > 1 and d == mesh.data_rank:
            mesh.edge_group = g
    return mesh


def data_seed(seed: int, mesh: Mesh) -> int:
    """A generator seed of this rank's data index: the ranks of one edge
    group draw the same dropout masks and LCGN context features for the
    node path they compute alike (the JAX step folds in the data index
    only)."""
    return seed + 1_000_003 * mesh.data_rank
