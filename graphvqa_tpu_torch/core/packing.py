"""Host-side ragged -> padded packing of scene graphs (numpy).

Port of ``graphvqa_tpu/core/packing.py``: ``pack_graphs`` (the flat layout)
with ``pick_bucket``, ``pack_graphs_dense`` (the dense layout) and the dense
ladder pickers. The layouts are byte-for-byte the JAX package's; the result
is a :class:`GraphBatch` of CPU tensors (move it with ``.to(device)``).
``core/native.py`` is the C++ twin of both packers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from graphvqa_tpu_torch.core.graph import GraphBatch


@dataclasses.dataclass
class GraphSample:
    """One ragged scene graph, host-side.

    node_tokens [n, max_obj_tokens] int32; edge_src / edge_dst [e] int32
    (graph-local); edge_tokens [e, max_edge_tokens] int32; edge_sym [e] bool
    (True for dataset-added reverse edges); exec_bitmap [n, steps] or None.
    """
    node_tokens: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_tokens: np.ndarray
    edge_sym: np.ndarray
    exec_bitmap: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return int(self.node_tokens.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])


def pack_graphs(
    samples: Sequence[GraphSample],
    nodes_pad: int,
    edges_pad: int,
    max_steps: int = 5,
) -> GraphBatch:
    """Concatenate, dst-sort (stable), and pad graphs: the flat layout.

    Padded nodes carry ``node_graph == len(samples)``; padded edges point at
    node ``nodes_pad - 1`` and sit after the real ones. Raises ValueError
    when the batch overflows the bucket (see ``pick_bucket``).
    """
    num_graphs = len(samples)
    total_nodes = sum(s.num_nodes for s in samples)
    total_edges = sum(s.num_edges for s in samples)
    if total_nodes > nodes_pad:
        raise ValueError(
            f"batch has {total_nodes} nodes > nodes_pad={nodes_pad}")
    if total_edges > edges_pad:
        raise ValueError(
            f"batch has {total_edges} edges > edges_pad={edges_pad}")

    tok_w = samples[0].node_tokens.shape[1] if samples else 12
    etok_w = samples[0].edge_tokens.shape[1] if samples else 1

    node_tokens = np.ones((nodes_pad, tok_w), dtype=np.int32)  # pad id 1
    node_graph = np.full((nodes_pad,), num_graphs, dtype=np.int32)
    node_mask = np.zeros((nodes_pad,), dtype=bool)
    edge_src = np.full((edges_pad,), nodes_pad - 1, dtype=np.int32)
    edge_dst = np.full((edges_pad,), nodes_pad - 1, dtype=np.int32)
    edge_tokens = np.ones((edges_pad, etok_w), dtype=np.int32)
    edge_mask = np.zeros((edges_pad,), dtype=bool)
    edge_sym_sign = np.ones((edges_pad,), dtype=np.float32)
    exec_bitmap = np.zeros((nodes_pad, max_steps), dtype=np.float32)

    node_off = 0
    srcs, dsts, etoks, esyms = [], [], [], []
    for gid, s in enumerate(samples):
        n = s.num_nodes
        node_tokens[node_off:node_off + n] = s.node_tokens
        node_graph[node_off:node_off + n] = gid
        node_mask[node_off:node_off + n] = True
        if s.exec_bitmap is not None:
            k = min(max_steps, s.exec_bitmap.shape[1])
            exec_bitmap[node_off:node_off + n, :k] = s.exec_bitmap[:, :k]
        srcs.append(s.edge_src.astype(np.int64) + node_off)
        dsts.append(s.edge_dst.astype(np.int64) + node_off)
        etoks.append(s.edge_tokens)
        esyms.append(s.edge_sym)
        node_off += n

    if total_edges:
        flat_src = np.concatenate(srcs)
        flat_dst = np.concatenate(dsts)
        flat_etok = np.concatenate(etoks, axis=0)
        flat_sym = np.concatenate(esyms)
        order = np.argsort(flat_dst, kind="stable")
        flat_src, flat_dst = flat_src[order], flat_dst[order]
        flat_etok, flat_sym = flat_etok[order], flat_sym[order]
        edge_src[:total_edges] = flat_src
        edge_dst[:total_edges] = flat_dst
        edge_tokens[:total_edges] = flat_etok
        edge_mask[:total_edges] = True
        edge_sym_sign[:total_edges] = np.where(flat_sym, -1.0, 1.0)

    t = torch.from_numpy
    return GraphBatch(
        node_tokens=t(node_tokens), node_graph=t(node_graph),
        node_mask=t(node_mask), edge_src=t(edge_src), edge_dst=t(edge_dst),
        edge_tokens=t(edge_tokens), edge_mask=t(edge_mask),
        edge_sym_sign=t(edge_sym_sign), exec_bitmap=t(exec_bitmap),
        num_graphs=num_graphs)


def pack_graphs_dense(
    samples: Sequence[GraphSample],
    nodes_per_graph: int,
    edges_per_graph: int,
    max_steps: int = 5,
    num_graphs: Optional[int] = None,
) -> GraphBatch:
    """Pack graphs with uniform per-graph padding (the dense layout).

    Graph g owns node rows [g*npg, (g+1)*npg) and edge rows [g*epg,
    (g+1)*epg). Edges are dst-sorted within each graph; padded edges point
    at their own graph's last node row and are masked. ``num_graphs`` >
    len(samples) appends fully padded dummy graphs.
    """
    B = num_graphs if num_graphs is not None else len(samples)
    if len(samples) > B:
        raise ValueError(f"{len(samples)} samples > num_graphs={B}")
    npg, epg = nodes_per_graph, edges_per_graph
    nodes_pad, edges_pad = B * npg, B * epg
    for i, s in enumerate(samples):
        if s.num_nodes > npg:
            raise ValueError(
                f"graph {i} has {s.num_nodes} nodes > nodes_per_graph={npg}")
        if s.num_edges > epg:
            raise ValueError(
                f"graph {i} has {s.num_edges} edges > edges_per_graph={epg}")

    tok_w = samples[0].node_tokens.shape[1] if samples else 12
    etok_w = samples[0].edge_tokens.shape[1] if samples else 1

    node_tokens = np.ones((nodes_pad, tok_w), dtype=np.int32)  # pad id 1
    node_graph = np.full((nodes_pad,), B, dtype=np.int32)
    node_mask = np.zeros((nodes_pad,), dtype=bool)
    pad_node = (np.arange(edges_pad) // epg) * npg + (npg - 1)
    edge_src = pad_node.astype(np.int32)
    edge_dst = pad_node.astype(np.int32)
    edge_tokens = np.ones((edges_pad, etok_w), dtype=np.int32)
    edge_mask = np.zeros((edges_pad,), dtype=bool)
    edge_sym_sign = np.ones((edges_pad,), dtype=np.float32)
    exec_bitmap = np.zeros((nodes_pad, max_steps), dtype=np.float32)

    for gid, s in enumerate(samples):
        n, e, off, eoff = s.num_nodes, s.num_edges, gid * npg, gid * epg
        node_tokens[off:off + n] = s.node_tokens
        node_graph[off:off + n] = gid
        node_mask[off:off + n] = True
        if s.exec_bitmap is not None:
            k = min(max_steps, s.exec_bitmap.shape[1])
            exec_bitmap[off:off + n, :k] = s.exec_bitmap[:, :k]
        if e:
            order = np.argsort(s.edge_dst.astype(np.int64), kind="stable")
            edge_src[eoff:eoff + e] = s.edge_src[order].astype(np.int64) + off
            edge_dst[eoff:eoff + e] = s.edge_dst[order].astype(np.int64) + off
            edge_tokens[eoff:eoff + e] = s.edge_tokens[order]
            edge_mask[eoff:eoff + e] = True
            edge_sym_sign[eoff:eoff + e] = np.where(
                s.edge_sym[order], -1.0, 1.0)

    t = torch.from_numpy
    return GraphBatch(
        node_tokens=t(node_tokens), node_graph=t(node_graph),
        node_mask=t(node_mask), edge_src=t(edge_src), edge_dst=t(edge_dst),
        edge_tokens=t(edge_tokens), edge_mask=t(edge_mask),
        edge_sym_sign=t(edge_sym_sign), exec_bitmap=t(exec_bitmap),
        num_graphs=B, nodes_per_graph=npg, edges_per_graph=epg)


# Flat buckets: (nodes_pad, edges_pad) per graph-count tier.
DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (256, 1024), (512, 2048), (1024, 4096), (2048, 8192),
    (4096, 16384), (8192, 32768), (16384, 131072), (32768, 262144),
)


def pick_bucket(total_nodes: int, total_edges: int,
                buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS
                ) -> Tuple[int, int]:
    """Smallest flat bucket that fits the batch."""
    for n_pad, e_pad in buckets:
        if total_nodes <= n_pad and total_edges <= e_pad:
            return n_pad, e_pad
    raise ValueError(
        f"no bucket fits total_nodes={total_nodes} total_edges={total_edges}; "
        f"largest is {buckets[-1]}")


# Dense per-graph paddings: the smallest rung that fits the largest graph.
DEFAULT_DENSE_NPG: Tuple[int, ...] = (16, 32, 64, 128)
DEFAULT_DENSE_EPG: Tuple[int, ...] = (64, 128, 256, 512, 1024)


def _pick(size: int, ladder: Sequence[int], what: str) -> int:
    for rung in ladder:
        if size <= rung:
            return rung
    raise ValueError(
        f"graph with {size} {what} exceeds the dense ladder {ladder}; "
        f"use the flat layout for this batch")


def pick_dense_npg(max_nodes: int,
                   ladder: Sequence[int] = DEFAULT_DENSE_NPG) -> int:
    """Smallest uniform per-graph node padding that fits ``max_nodes``."""
    return _pick(max_nodes, ladder, "nodes")


def pick_dense_epg(max_edges: int,
                   ladder: Sequence[int] = DEFAULT_DENSE_EPG) -> int:
    """Smallest uniform per-graph edge padding that fits ``max_edges``."""
    return _pick(max_edges, ladder, "edges")
