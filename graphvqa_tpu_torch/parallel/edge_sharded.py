"""Destination-ownership edge sharding of the whole model (port of
``graphvqa_tpu/parallel/edge_sharded.py``).

The K ranks of an edge group share one batch. Edge rank ``e`` holds the
edges whose local destination index ``i`` has ``i % K == e``
(:func:`shard_edges_by_dst`), so every destination's softmax is local to one
rank. Each aggregation (the GAT round, the MetaLayer's and the engines'
edge sums, the weighted scatter) gives the owned destinations' rows, and
one all-reduce over the edge group assembles them into the replicated node
rows (``parallel/collectives.py:assemble_rows``). Everything on the node
path (projections, BatchNorm, transformers, pooling) is computed alike on
every edge rank: exchanging projected features would cost more than
recomputing them. The GAT kernels run on each rank's share at ``(npg, epg_loc)``.

Gradients: each rank scales its loss by 1/K and the assembly sums the
cotangent shares in its backward (``parallel/collectives.py:AssembleRows``),
so every rank's parameter gradient is a share and the K shares sum to the
single-device gradient; the data-parallel step's one all-reduce sums them
(``parallel/data_parallel.py``). On the card the train and eval steps
replay CUDA graphs per batch shape, cut at each collective through gloo
and whole over NCCL (``train/graphs.py``), as JAX jits its edge steps.

Random streams are seeded by the data rank only, so the edge ranks of a
data index draw the same node-path dropout masks and LCGN context features;
their attention-dropout masks come from that stream too and are therefore
correlated across the shards, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from graphvqa_tpu_torch.config import Config
from graphvqa_tpu_torch.core.graph import GraphBatch, QABatch
from graphvqa_tpu_torch.models.pipeline import PipelineModel
from graphvqa_tpu_torch.parallel.data_parallel import make_dp_train_step
from graphvqa_tpu_torch.parallel.mesh import Mesh
from graphvqa_tpu_torch.train.loop import make_eval_step

# GraphBatch fields indexed by edge slot
EDGE_FIELDS = ("edge_src", "edge_dst", "edge_tokens", "edge_mask",
               "edge_sym_sign")


def shard_padding(epg: int, k: int, need: int) -> int:
    """Per-shard edge padding: ``epg // k``, doubled (up to ``epg``) until
    the largest (graph, shard) bucket, ``need``, fits."""
    epg_loc = max(epg // k, 1)
    while epg_loc < need:
        epg_loc = min(epg_loc * 2, epg)
    return epg_loc


def dst_shard_need(graphs: GraphBatch, k: int) -> int:
    """Largest (graph, shard) bucket under destination ownership: the least
    ``edges_per_shard`` that fits this batch."""
    B, npg, epg = (graphs.num_graphs, graphs.nodes_per_graph,
                   graphs.edges_per_graph)
    dst = graphs.edge_dst.numpy().reshape(-1)
    mask = graphs.edge_mask.numpy().reshape(-1).astype(bool)
    gids = np.repeat(np.arange(B, dtype=np.int64), epg)
    key = gids * k + (dst % npg) % k
    return int(np.bincount(key[mask], minlength=B * k).max()) \
        if mask.any() else 0


def shard_edges_by_dst(graphs: GraphBatch, k: int,
                       edges_per_shard: Optional[int] = None) -> GraphBatch:
    """Partition every graph's edges over ``k`` shards by destination
    ownership, on the host in numpy: edge fields [B*epg, ...] become
    [k, B*epg_loc, ...], each (graph, shard) bucket in the batch's
    (destination-sorted) order, padded with edges ``(npg-1, npg-1)`` of its
    graph, masked out. ``edges_per_shard`` None takes
    :func:`shard_padding`; a bucket that does not fit it raises."""
    B, npg, epg = (graphs.num_graphs, graphs.nodes_per_graph,
                   graphs.edges_per_graph)
    if not graphs.has_dense_layout:
        raise ValueError("edge sharding needs the dense layout")
    if npg % k:
        raise ValueError(f"nodes_per_graph={npg} not divisible by k={k}")
    src = graphs.edge_src.numpy().reshape(-1)
    dst = graphs.edge_dst.numpy().reshape(-1)
    mask = graphs.edge_mask.numpy().reshape(-1).astype(bool)
    etok = graphs.edge_tokens.numpy().reshape(B * epg, -1)
    esym = graphs.edge_sym_sign.numpy().reshape(-1)

    # group the real edges by (graph, owner) with a stable sort on the
    # bucket key: each bucket keeps the destination order
    gids = np.repeat(np.arange(B, dtype=np.int64), epg)
    key = gids * k + (dst % npg) % k
    valid = np.nonzero(mask)[0]
    order = np.argsort(key[valid], kind="stable")
    idx, kk = valid[order], key[valid][order]
    need = dst_shard_need(graphs, k)
    epg_loc = (shard_padding(epg, k, need) if edges_per_shard is None
               else edges_per_shard)
    if need > epg_loc:
        raise ValueError(
            f"edge shard bucket overflow: a (graph, shard) needs {need} "
            f"slots > edges_per_shard={epg_loc}")

    etok_w = etok.shape[-1]
    pad_node = (np.arange(B) * npg + (npg - 1)).astype(np.int32)
    o_src = np.broadcast_to(pad_node[None, :, None], (k, B, epg_loc)).copy()
    o_dst = o_src.copy()
    o_tok = np.ones((k, B, epg_loc, etok_w), np.int32)
    o_mask = np.zeros((k, B, epg_loc), bool)
    o_sym = np.ones((k, B, epg_loc), np.float32)
    if kk.size:
        # slot of each grouped edge within its (graph, shard) bucket
        starts = np.r_[0, np.nonzero(np.diff(kk))[0] + 1]
        sizes = np.diff(np.r_[starts, len(kk)])
        pos = np.arange(len(kk)) - np.repeat(starts, sizes)
        g_of, s_of = kk // k, kk % k
        o_src[s_of, g_of, pos] = src[idx]
        o_dst[s_of, g_of, pos] = dst[idx]
        o_tok[s_of, g_of, pos] = etok[idx]
        o_mask[s_of, g_of, pos] = True
        o_sym[s_of, g_of, pos] = esym[idx]
    t = torch.from_numpy
    return dataclasses.replace(
        graphs,
        edge_src=t(o_src.reshape(k, B * epg_loc)),
        edge_dst=t(o_dst.reshape(k, B * epg_loc)),
        edge_tokens=t(o_tok.reshape(k, B * epg_loc, etok_w)),
        edge_mask=t(o_mask.reshape(k, B * epg_loc)),
        edge_sym_sign=t(o_sym.reshape(k, B * epg_loc)))


def local_shard(sharded: GraphBatch, rank: int,
                group: Optional[object]) -> GraphBatch:
    """Edge rank ``rank``'s share of a :func:`shard_edges_by_dst` batch,
    marked as sharded over ``group``."""
    local = {f: getattr(sharded, f)[rank] for f in EDGE_FIELDS}
    epg_loc = local["edge_src"].shape[0] // sharded.num_graphs
    return dataclasses.replace(sharded, edges_per_graph=epg_loc,
                               edge_group=group, **local)


def prepare_dp_edge_batch(batches: Sequence[QABatch], mesh: Mesh,
                          edges_per_shard: Optional[int] = None
                          ) -> List[QABatch]:
    """This rank's share of each of ``batches`` (dense, on the host): the
    edges partitioned by destination ownership over the edge group (the
    native packer's ``gp_shard_by_dst``), each batch at its own per-shard
    padding (:func:`shard_padding`, or ``edges_per_shard``), and this edge
    rank's share kept. The JAX package pads a step's whole group alike
    because it stacks them; here no batch is stacked. The ranks of an edge
    group get the same batches, so they agree on the padding."""
    from graphvqa_tpu_torch.core.native import shard_edges_by_dst_native
    return [dataclasses.replace(b, graphs=local_shard(
        shard_edges_by_dst_native(b.graphs, mesh.edge, edges_per_shard),
        mesh.edge_rank, mesh.edge_group)) for b in batches]


def prepare_edge_eval_batch(batch: QABatch, mesh: Mesh,
                            edges_per_shard: Optional[int] = None
                            ) -> QABatch:
    """This rank's share of one eval batch (:func:`prepare_dp_edge_batch`
    of one)."""
    return prepare_dp_edge_batch([batch], mesh, edges_per_shard)[0]


# The JAX package's name for the train step on a data x edge mesh: it is
# make_dp_train_step, whose one all-reduce sums the edge ranks' gradient
# shares (each rank scales its loss by 1/K) with the data ranks' gradients.
# Batches come from prepare_dp_edge_batch (a list of K for K steps a call,
# K replays on the card: JAX's dp_edge_multi_step).
make_dp_edge_train_step = make_dp_train_step


def make_edge_eval_step(model: PipelineModel, cfg: Config, mesh: Mesh,
                        capture: bool = True) -> Callable:
    """Greedy-decode evaluation with the edges sharded as in training:
    make_eval_step's step (same signature and outputs, which come out alike
    on every edge rank) on batches from :func:`prepare_edge_eval_batch`.
    On the card each request replays its batch shape's graphs, cut at the
    forward's collectives through gloo, whole over NCCL
    (``train/graphs.py``); ``capture=False`` keeps the eager step (the
    graphs are ``edge_eval_step.graphs``)."""
    step = make_eval_step(model, cfg, capture=capture)

    def edge_eval_step(batch: QABatch, generator=None):
        if mesh.edge > 1 and batch.graphs.edge_group is None:
            raise ValueError("an edge axis needs batches from "
                             "edge_sharded.prepare_edge_eval_batch")
        return step(batch, generator)

    edge_eval_step.graphs = step.graphs
    return edge_eval_step
