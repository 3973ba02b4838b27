"""GQA scene-graph JSON -> ragged GraphSample arrays (port of
``graphvqa_tpu/data/scene_graph.py``; the samples are the port's
:class:`~graphvqa_tpu_torch.core.packing.GraphSample`).

Host-side graph conversion replacing ``convert_one_gqa_scene_graph``
(reference: gqa_dataset_entry.py:190-372). Semantics preserved:

  * node order = sorted object-id strings;
  * node features = [name token, up to 11 deduplicated attribute tokens,
    pad...] (MAX_OBJ_TOKEN_LEN=12, gqa_dataset_entry.py:268);
  * every node gets a ``<self>`` self-loop edge before its outgoing relations;
  * missing reverse edges are added with the same relation token and flagged
    (``edge_sym``) so the encoder can sign-flip their embeddings
    (gqa_dataset_entry.py:323-332);
  * empty scenes become the dummy 2-node <UNK> graph
    (gqa_dataset_entry.py:196-224).

Attribute dedup uses ``dict.fromkeys`` (insertion-ordered) rather than the
reference's ``set`` (arbitrary iteration order) so token arrays are
deterministic across runs; the set of tokens is identical.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from graphvqa_tpu_torch.core.packing import GraphSample
from graphvqa_tpu_torch.data.vocab import Vocab

MAX_OBJ_TOKEN_LEN = 12
_DUMMY_SCENE = {
    "objects": {
        "0": {"name": "<UNK>", "attributes": ["<UNK>"],
              "relations": [{"object": "1", "name": "<UNK>"}]},
        "1": {"name": "<UNK>", "attributes": ["<UNK>"],
              "relations": [{"object": "0", "name": "<UNK>"}]},
    }
}


def convert_scene_graph(
    sg: dict,
    sg_vocab: Vocab,
    max_obj_tokens: int = MAX_OBJ_TOKEN_LEN,
) -> GraphSample:
    if not sg.get("objects"):
        sg = _DUMMY_SCENE

    obj_ids = sorted(sg["objects"].keys())
    idx_of: Dict[str, int] = {oid: i for i, oid in enumerate(obj_ids)}
    n = len(obj_ids)

    self_tok = sg_vocab.lookup("<self>")
    pad_tok = sg_vocab.stoi["<pad>"]

    node_tokens = np.full((n, max_obj_tokens), pad_tok, dtype=np.int32)
    edge_src: List[int] = []
    edge_dst: List[int] = []
    edge_tok: List[int] = []
    edge_sym: List[bool] = []

    # forward-connection set for symmetrization
    connected = set()
    for oid in obj_ids:
        for rel in sg["objects"][oid].get("relations", []):
            connected.add((idx_of[oid], idx_of[rel["object"]]))

    for i, oid in enumerate(obj_ids):
        obj = sg["objects"][oid]
        node_tokens[i, 0] = sg_vocab.lookup(obj["name"])
        for k, attr in enumerate(dict.fromkeys(obj.get("attributes", []))):
            if k + 1 >= max_obj_tokens:
                break
            node_tokens[i, k + 1] = sg_vocab.lookup(attr)

        # self-loop first (gqa_dataset_entry.py:295-297)
        edge_src.append(i)
        edge_dst.append(i)
        edge_tok.append(self_tok)
        edge_sym.append(False)

        for rel in obj.get("relations", []):
            j = idx_of[rel["object"]]
            tok = sg_vocab.lookup(rel["name"])
            edge_src.append(i)
            edge_dst.append(j)
            edge_tok.append(tok)
            edge_sym.append(False)
            if (j, i) not in connected:
                edge_src.append(j)
                edge_dst.append(i)
                edge_tok.append(tok)
                edge_sym.append(True)

    return GraphSample(
        node_tokens=node_tokens,
        edge_src=np.asarray(edge_src, np.int32),
        edge_dst=np.asarray(edge_dst, np.int32),
        edge_tokens=np.asarray(edge_tok, np.int32).reshape(-1, 1),
        edge_sym=np.asarray(edge_sym, bool),
    )


def build_execution_bitmap(
    num_nodes: int,
    execution_buffer: Sequence[Sequence[int]],
    max_steps: int = 5,
) -> np.ndarray:
    """Per-node x per-step GT execution bitmap with last-step padding
    (reference: gqa_dataset_entry.py:111-134). An empty buffer yields zeros."""
    bitmap = np.zeros((num_nodes, max_steps), dtype=np.float32)
    annotated = min(len(execution_buffer), max_steps)
    for step in range(annotated):
        for node in execution_buffer[step]:
            if 0 <= node < num_nodes:
                bitmap[node, step] = 1.0
    if annotated:
        for step in range(annotated, max_steps):
            bitmap[:, step] = bitmap[:, annotated - 1]
    return bitmap
