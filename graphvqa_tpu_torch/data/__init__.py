"""The host data path of the port: text, vocabularies, scene graphs, the
dataset with its collate and worker pool, prefetch and synthetic data."""
from graphvqa_tpu_torch.data.dataset import GQADataset, collate_qa
from graphvqa_tpu_torch.data.scene_graph import (
    build_execution_bitmap, convert_scene_graph)
from graphvqa_tpu_torch.data.tokenizer import tokenize
from graphvqa_tpu_torch.data.vocab import (
    Vocab, build_scene_graph_vocab, build_text_vocab)

__all__ = [
    "tokenize", "Vocab", "build_scene_graph_vocab", "build_text_vocab",
    "convert_scene_graph", "build_execution_bitmap", "GQADataset", "collate_qa",
]
