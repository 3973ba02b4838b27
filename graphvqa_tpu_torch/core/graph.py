"""Static-shape graph batch containers (port of ``graphvqa_tpu/core/graph.py``).

Plain dataclasses of tensors with the JAX package's field names and padding
conventions:

  * nodes and edges of all graphs are concatenated into flat arrays of static
    length ``nodes_pad`` / ``edges_pad``; padded nodes carry
    ``node_graph == num_graphs``;
  * edges are sorted by destination; padded edges are masked out of every
    aggregation;
  * ``edge_sym_sign`` is -1 for dataset-added reverse edges, else +1.

Under destination-ownership edge sharding (``parallel/edge_sharded.py``)
a dense batch holds one edge rank's share of every graph's edges:
``edges_per_graph`` is the shard's padding and ``edge_group`` the process
group of the ranks that share the batch's nodes (None: not sharded).

Two layouts, as in the JAX package. The dense layout (``nodes_per_graph``
and ``edges_per_graph`` set): every graph is padded to exactly
``nodes_per_graph`` node rows and ``edges_per_graph`` edge rows, so graph g
owns node rows [g*npg, (g+1)*npg) and edge rows [g*epg, (g+1)*epg), and flat
arrays reshape to [B, npg, ...] / [B, epg, ...] for free. The flat layout
(both 0): the graphs' nodes and edges concatenated and padded to a static
``nodes_pad`` / ``edges_pad``, padded edges pointing at the last node row;
the collate falls back to it for a graph beyond the dense ladder.

The containers also carry numpy arrays: the collate's worker processes build
them so (``to_numpy``) and the parent wraps them back (``from_numpy``),
zero-copy both ways. ``.to`` is the span ``gvqa.batch.to_device`` when the
program's tracing is on (``core/profiling.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from graphvqa_tpu_torch.core import profiling
from graphvqa_tpu_torch.core.device import DeviceLike, resolve_device


def _map_arrays(obj, fn, kind):
    """``obj`` with ``fn`` applied to every field of type ``kind``
    (nested containers included)."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, kind):
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _map_arrays(v, fn, kind)
    return dataclasses.replace(obj, **changes)


def _move(obj, device: torch.device):
    with profiling.span("gvqa.batch.to_device"):
        return _map_arrays(obj, lambda t: t.to(device), torch.Tensor)


def to_numpy(obj):
    """A container of CPU tensors as the same container of numpy arrays."""
    return _map_arrays(obj, lambda t: t.numpy(), torch.Tensor)


def from_numpy(obj):
    """A container of numpy arrays as the same container of CPU tensors."""
    return _map_arrays(obj, torch.from_numpy, np.ndarray)


@dataclasses.dataclass
class GraphBatch:
    """A padded batch of scene graphs.

      node_tokens   [nodes_pad, max_obj_tokens] int32
      node_graph    [nodes_pad] int32, graph id; num_graphs marks padding
      node_mask     [nodes_pad] bool
      edge_src      [edges_pad] int32, flat source node index
      edge_dst      [edges_pad] int32, flat destination index, sorted
      edge_tokens   [edges_pad, max_edge_tokens] int32
      edge_mask     [edges_pad] bool
      edge_sym_sign [edges_pad] float32
      exec_bitmap   [nodes_pad, max_steps] float32
    """
    node_tokens: torch.Tensor
    node_graph: torch.Tensor
    node_mask: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_tokens: torch.Tensor
    edge_mask: torch.Tensor
    edge_sym_sign: torch.Tensor
    exec_bitmap: torch.Tensor
    num_graphs: int
    nodes_per_graph: int = 0
    edges_per_graph: int = 0
    edge_group: Optional[object] = None

    @property
    def nodes_pad(self) -> int:
        return self.node_tokens.shape[0]

    @property
    def edges_pad(self) -> int:
        return self.edge_src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_tokens.device

    @property
    def has_dense_layout(self) -> bool:
        return self.nodes_per_graph > 0 and self.edges_per_graph > 0

    def edge_graph(self) -> torch.Tensor:
        """Graph id per edge through its source node; padded edges map to
        ``num_graphs``."""
        eg = self.node_graph.index_select(0, self.edge_src)
        return torch.where(self.edge_mask, eg, self.num_graphs)

    def to(self, device: DeviceLike = None) -> "GraphBatch":
        return _move(self, resolve_device(device))


@dataclasses.dataclass
class QABatch:
    """One eval batch: graphs plus tokenized text and labels.

      questions          [B, question_len] int32
      programs           [B * max_steps, program_len] int32
      full_answers       [B, full_answer_len] int32
      short_answer_label [B] int32
    """
    graphs: GraphBatch
    questions: torch.Tensor
    programs: torch.Tensor
    full_answers: torch.Tensor
    short_answer_label: torch.Tensor

    def to(self, device: DeviceLike = None) -> "QABatch":
        return _move(self, resolve_device(device))
