"""GQA dataset and static-shape collate (port of
``graphvqa_tpu/data/dataset.py``).

Items are the 11-field preprocessed tuples of ``*_programs.json``; a batch is
a :class:`~graphvqa_tpu_torch.core.graph.QABatch` of CPU tensors in the
configured dense shape, a bigger rung of the dense ladder, or the flat
layout, exactly as the JAX package collates it (byte-equal arrays).

``iter_batches(num_workers=N)`` collates in N forked worker processes, a
persistent pool reused across epochs. The workers touch no device: they
return the batch as numpy arrays (``core.graph.to_numpy``), and the parent
wraps them back into tensors without a copy (``from_numpy``), so no tensor
crosses the pool through shared-memory file descriptors. Fork start, as in
the JAX package: the pool forks after the model and the CUDA context exist,
and the children never use either.
"""
from __future__ import annotations

import json
import logging
import multiprocessing as mp
import os
import pathlib
import time
from collections import deque
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from graphvqa_tpu_torch.config import BatchConfig
from graphvqa_tpu_torch.core.graph import QABatch, from_numpy, to_numpy
from graphvqa_tpu_torch.core.native import (
    pack_graphs_dense_native, pack_graphs_native)
from graphvqa_tpu_torch.core.packing import GraphSample
from graphvqa_tpu_torch.data.scene_graph import (
    build_execution_bitmap, convert_scene_graph)
from graphvqa_tpu_torch.data.tokenizer import tokenize
from graphvqa_tpu_torch.data.vocab import Vocab, load_answer_maps

MAX_EXECUTION_STEP = 5  # gqa_dataset_entry.py:387


class GQADataset:
    """One split of preprocessed GQA questions and ground-truth scene graphs.

    programs_path: ``<split>_programs.json`` (11-field tuples);
    scene_graphs_path: GQA ``*_sceneGraphs.json`` (None for testdev);
    text_vocab / sg_vocab: the QA-side and scene-graph vocabularies.
    """

    def __init__(self, programs_path, scene_graphs_path, text_vocab: Vocab,
                 sg_vocab: Vocab, max_steps: int = MAX_EXECUTION_STEP):
        self.data = json.loads(pathlib.Path(programs_path).read_text())
        self.sg_data = (json.loads(pathlib.Path(scene_graphs_path).read_text())
                        if scene_graphs_path else None)
        self.text_vocab = text_vocab
        self.sg_vocab = sg_vocab
        self.max_steps = max_steps
        self.ans2label, self.label2ans = load_answer_maps()
        self._graph_cache: Dict[str, GraphSample] = {}
        self._text_cache: Dict[int, tuple] = {}
        self._sizes = None
        self._pools: Dict[int, object] = {}

    def __len__(self) -> int:
        return len(self.data)

    @property
    def num_answers(self) -> int:
        return len(self.ans2label)

    def _graph_for(self, image_id: str) -> GraphSample:
        g = self._graph_cache.get(image_id)
        if g is None:
            sg = self.sg_data[image_id] if self.sg_data else {}
            g = convert_scene_graph(sg, self.sg_vocab)
            self._graph_cache[image_id] = g
        return g

    def _text_for(self, index: int) -> tuple:
        """(question_ids, per-instruction id lists, full_answer_ids), cached
        per row across epochs."""
        cached = self._text_cache.get(index)
        if cached is not None:
            return cached
        datum = self.data[index]
        look = self.text_vocab.lookup
        q_ids = [look(t) for t in tokenize(datum[1])]
        programs = list(datum[9][: self.max_steps])
        programs += [[]] * (self.max_steps - len(programs))
        prog_ids = [[look(t) for t in instr] for instr in programs]
        fa_ids = [look(t) for t in tokenize(datum[5])]
        out = (q_ids, prog_ids, fa_ids)
        self._text_cache[index] = out
        return out

    def prewarm(self) -> None:
        """Fill the text-id and graph caches up front, so forked workers
        inherit them warm. Idempotent."""
        for i in range(len(self)):
            self._text_for(i)
        if self.sg_data:
            for iid in self.sg_data:
                self._graph_for(str(iid))

    def __getitem__(self, index: int) -> dict:
        datum = self.data[index]
        image_id = str(datum[0])
        short_answer = datum[4]
        if short_answer == "bottle cap":    # gqa_dataset_entry.py:500-505
            short_answer = "bottle"
        graph = self._graph_for(image_id)
        bitmap = build_execution_bitmap(graph.num_nodes, datum[8],
                                        self.max_steps)
        q_ids, prog_ids, fa_ids = self._text_for(index)
        return {
            "question_id": datum[3],
            "image_id": image_id,
            "question_ids": q_ids,
            "question_text": datum[1],
            "graph": GraphSample(
                node_tokens=graph.node_tokens, edge_src=graph.edge_src,
                edge_dst=graph.edge_dst, edge_tokens=graph.edge_tokens,
                edge_sym=graph.edge_sym, exec_bitmap=bitmap),
            "program_ids": prog_ids,
            "full_answer_ids": fa_ids,
            "short_answer_label": self.ans2label[short_answer],
            "short_answer": short_answer,
            "types": datum[10],
        }

    def graph_size(self, index: int) -> int:
        """Node count of the sample's scene without building the graph
        (dummy scenes count 2)."""
        if self._sizes is None:
            sizes = {}
            if self.sg_data:
                for iid, sg in self.sg_data.items():
                    sizes[iid] = len(sg.get("objects", {})) or 2
            self._sizes = np.asarray(
                [sizes.get(str(d[0]), 2) for d in self.data], np.int32)
        return int(self._sizes[index])

    def batch_order(self, batch_cfg: BatchConfig, shuffle: bool = False,
                    seed: int = 0, drop_last: bool = False,
                    shard_index: int = 0, num_shards: int = 1,
                    size_bucket_windows: int = 0,
                    permute_group: int = 1) -> list:
        """The epoch's batches as index arrays, in the order
        ``iter_batches`` yields them (the JAX package's order)."""
        total = len(self)
        order = np.arange(total)
        rng = np.random.default_rng(seed)
        if shuffle:
            rng.shuffle(order)
        if num_shards > 1:
            order = order[shard_index::num_shards]
        bs = batch_cfg.num_graphs
        if shuffle and size_bucket_windows > 0:
            if drop_last and len(order) >= bs:
                # trim the drop_last remainder from the shuffled order before
                # sorting, or it would always be a window's largest graphs
                order = order[: len(order) // bs * bs]
            self.graph_size(0)
            win = size_bucket_windows * bs
            parts = [w[np.argsort(self._sizes[w], kind="stable")]
                     for w in (order[s:s + win]
                               for s in range(0, len(order), win))]
            order = np.concatenate(parts) if parts else order
        chunks = []
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            if len(idx) < bs and drop_last:
                break
            chunks.append(idx)
        if shuffle and size_bucket_windows > 0 and len(chunks) > 1:
            # shuffle the batch order again, in groups of permute_group
            # consecutive batches (a partial group stays last)
            g = max(permute_group, 1)
            n_full = len(chunks) // g
            tail = chunks[n_full * g:]
            chunks = [chunks[i] for j in rng.permutation(n_full)
                      for i in range(j * g, (j + 1) * g)] + tail
        if num_shards > 1:
            # equal batch counts on every shard: drop_last stops at the
            # shortest, otherwise short shards end with empty batches
            if drop_last:
                chunks = chunks[: (total // num_shards) // bs]
            else:
                max_len = total // num_shards + (1 if total % num_shards
                                                 else 0)
                want = -(-max_len // bs)
                while len(chunks) < want:
                    chunks.append(np.zeros((0,), np.int64))
        return chunks

    def iter_batches(self, batch_cfg: BatchConfig, shuffle: bool = False,
                     seed: int = 0, drop_last: bool = False,
                     shard_index: int = 0, num_shards: int = 1,
                     num_workers: int = 0, size_bucket_windows: int = 0,
                     permute_group: int = 1) -> Iterator[tuple]:
        """Yield (meta, QABatch) pairs in ``batch_order``; meta carries the
        ids, texts, answers and types for the result dump, ``real_count``,
        the batch's ``layout``, and ``collate_s`` and ``collate_pid``: the
        seconds its collate took on the host clock, and the process that
        ran it (a pool worker, or this process with 0 workers).

        ``shard_index/num_shards``: per-process input sharding.
        ``size_bucket_windows`` W > 0 (shuffled epochs): each window of W
        batches is sorted by scene size before it is cut, so one big graph
        bumps few batches to a bigger rung; ``permute_group`` keeps groups
        of that many size-adjacent batches together when the batch order is
        shuffled again. ``num_workers`` > 0 collates in the persistent fork
        pool with at most 2 * num_workers batches in flight; each batch's
        layout is counted into this process's ``collate_stats``.
        """
        chunks = self.batch_order(batch_cfg, shuffle, seed, drop_last,
                                  shard_index, num_shards,
                                  size_bucket_windows, permute_group)
        if num_workers <= 0:
            for idx in chunks:
                yield build_batch(self, idx, batch_cfg, self.max_steps)
            return
        pool = self._worker_pool(num_workers)
        # bounded look-ahead (not pool.imap, which queues the whole epoch);
        # the finally-drain leaves the shared pool quiet when the caller
        # stops early
        pending: deque = deque()
        it = iter(chunks)
        exhausted = False
        try:
            while True:
                while not exhausted and len(pending) < 2 * num_workers:
                    idx = next(it, None)
                    if idx is None:
                        exhausted = True
                        break
                    pending.append(pool.apply_async(
                        _pool_build, ((idx, batch_cfg, self.max_steps),)))
                if not pending:
                    return
                meta, arrays = pending.popleft().get()
                layout = meta.get("layout")
                if layout in collate_stats:
                    collate_stats[layout] += 1
                yield meta, from_numpy(arrays)
        finally:
            for r in pending:
                r.wait(timeout=60)

    def _worker_pool(self, num_workers: int):
        """Persistent fork pool, reused across epochs; the dataset reaches
        the workers through a module global inherited by fork. A request for
        another size closes the old pool (its workers finish their queue and
        exit)."""
        pool = self._pools.get(num_workers)
        if pool is not None:
            return pool
        for size, old in list(self._pools.items()):
            old.close()
            del self._pools[size]
        global _WORKER_DS
        _WORKER_DS = self
        pool = mp.get_context("fork").Pool(num_workers)
        self._pools[num_workers] = pool
        return pool

    def close(self) -> None:
        """Stop the worker pool (its workers finish their queue and exit)."""
        for pool in self._pools.values():
            pool.close()
            pool.join()
        self._pools.clear()


_WORKER_DS: Optional[GQADataset] = None


def _pool_build(args):
    """A worker's batch: numpy arrays only, no tensor crosses the pool."""
    idx, batch_cfg, max_steps = args
    meta, batch = build_batch(_WORKER_DS, idx, batch_cfg, max_steps)
    return meta, to_numpy(batch)


def build_batch(ds: GQADataset, idx, batch_cfg: BatchConfig,
                max_steps: int) -> tuple:
    """One (meta, QABatch) from dataset indices. A ragged batch repeats its
    last item up to the static batch size; an empty index set (a shard's
    padding batch) templates from row 0 with real_count 0. The meta's
    ``collate_s`` is this call's time on the host clock, ``collate_pid``
    the process that ran it."""
    t0 = time.perf_counter()
    items = [ds[int(i)] for i in idx]
    real = len(items)
    if not items:
        items = [ds[0]]
    while len(items) < batch_cfg.num_graphs:
        items.append(items[-1])
    batch = collate_qa(items, batch_cfg, ds.text_vocab, max_steps=max_steps)
    meta = {"question_ids": [it["question_id"] for it in items],
            "image_ids": [it["image_id"] for it in items],
            "questions": [it["question_text"] for it in items],
            "answers": [it["short_answer"] for it in items],
            "types": [it["types"] for it in items],
            "real_count": real}
    if batch_cfg.layout == "dense":
        g = batch.graphs
        if not g.has_dense_layout:
            meta["layout"] = "flat_fallback"
        elif (g.nodes_per_graph != batch_cfg.nodes_per_graph
              or g.edges_per_graph != batch_cfg.edges_per_graph):
            meta["layout"] = "dense_bumped"
        else:
            meta["layout"] = "dense"
    meta["collate_s"] = time.perf_counter() - t0
    meta["collate_pid"] = os.getpid()
    return meta, batch


# How often batches left the configured dense shape (per process; the pool's
# outcomes are folded back by iter_batches): ``dense_bumped`` batches run at
# a bigger rung of the ladder, ``flat_fallback`` ones in the flat layout.
collate_stats = {"dense": 0, "dense_bumped": 0, "flat_fallback": 0}


def _ladder(base: int, need: int, cap_mult: int = 8) -> Optional[int]:
    """Double the configured padding until ``need`` fits, up to cap_mult
    times it; None beyond that."""
    v = base
    while v < need and v < base * cap_mult:
        v *= 2
    return v if need <= v else None


def collate_qa(items: Sequence[dict], batch_cfg: BatchConfig,
               text_vocab: Vocab, max_steps: int = MAX_EXECUTION_STEP
               ) -> QABatch:
    """Static-shape collate (reference: gqa_dataset_entry.py:631-675).

    Programs are flattened to ``B * max_steps`` rows (sample-major). The
    dense layout doubles the configured per-graph padding of nodes and of
    edges, each on its own, until the largest graph fits (at most 8x);
    beyond that the batch falls back to the flat layout, with a warning and
    a count in ``collate_stats``.
    """
    graph_samples = [it["graph"] for it in items]
    max_n = max(g.num_nodes for g in graph_samples)
    max_e = max(g.num_edges for g in graph_samples)
    npg = epg = None
    if batch_cfg.layout == "dense":
        npg = _ladder(batch_cfg.nodes_per_graph, max_n)
        epg = _ladder(batch_cfg.edges_per_graph, max_e)
        if npg is None or epg is None:
            npg = epg = None
    if npg is not None:
        bumped = (npg != batch_cfg.nodes_per_graph
                  or epg != batch_cfg.edges_per_graph)
        collate_stats["dense_bumped" if bumped else "dense"] += 1
        if bumped:
            logging.info(
                "collate: graph with %d nodes / %d edges bumped the dense "
                "bucket to npg=%d epg=%d", max_n, max_e, npg, epg)
        graphs = pack_graphs_dense_native(
            graph_samples, npg, epg, max_steps=max_steps,
            num_graphs=batch_cfg.num_graphs)
    else:
        if batch_cfg.layout == "dense":
            collate_stats["flat_fallback"] += 1
            logging.warning(
                "collate: graph with %d nodes / %d edges exceeds the dense "
                "ladder; the batch falls back to the flat layout; "
                "flat_fallback count=%d", max_n, max_e,
                collate_stats["flat_fallback"])
        graphs = pack_graphs_native(graph_samples,
                                    nodes_pad=batch_cfg.nodes_pad,
                                    edges_pad=batch_cfg.edges_pad,
                                    max_steps=max_steps)

    def enc(it, ids_key, tok_key, length):
        # dataset rows carry cached ids; hand-built items may carry tokens
        if ids_key in it:
            return text_vocab.encode_ids(it[ids_key], length)
        return text_vocab.encode(it[tok_key], length)

    questions = np.stack([enc(it, "question_ids", "question_tokens",
                              batch_cfg.question_len) for it in items])
    if "program_ids" in items[0]:
        programs = np.stack([
            text_vocab.encode_ids(instr, batch_cfg.program_len)
            for it in items for instr in it["program_ids"]])
    else:
        programs = np.stack([text_vocab.encode(instr, batch_cfg.program_len)
                             for it in items for instr in it["programs"]])
    full_answers = np.stack([enc(it, "full_answer_ids", "full_answer_tokens",
                                 batch_cfg.full_answer_len) for it in items])
    labels = np.asarray([it["short_answer_label"] for it in items], np.int32)
    return from_numpy(QABatch(graphs=graphs, questions=questions,
                              programs=programs, full_answers=full_answers,
                              short_answer_label=labels))
