"""Scene-graph and question encoders (port of ``graphvqa_tpu/nn/encoders.py``).

Scene graph: token embeddings summed over slots, the sign flip of
dataset-added reverse edges, one MetaLayer round, then the per-graph
LayerNorm with scalar affine (either layout). Question: the shared text embedding, a linear
projection times sqrt(d), sinusoidal positions with dropout, a post-LN
encoder stack (dropout as ``nn/transformer.py`` places it; ``generator=None``
is deterministic).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from graphvqa_tpu_torch.core.graph import GraphBatch
from graphvqa_tpu_torch.nn.embedding import PaddedEmbed
from graphvqa_tpu_torch.nn.gnn import SceneGraphMetaLayer
from graphvqa_tpu_torch.nn.transformer import (
    PositionalEncoding, TorchLinear, TransformerEncoder)
from graphvqa_tpu_torch.ops.layernorm import graph_layer_norm_any


class GraphLayerNormParams(nn.Module):
    """The reference graph LayerNorm's 1-element affine tensors."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))


class SceneGraphEncoder(nn.Module):
    def __init__(self, vocab_size: int, emb_dim: int = 300, pad_idx: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.sg_vocab_embedding = PaddedEmbed(vocab_size, emb_dim, pad_idx)
        self.scene_graph_encoding_layer = SceneGraphMetaLayer(
            emb_dim, emb_dim, dtype)
        self.graph_layer_norm = GraphLayerNormParams()

    def forward(self, graph: GraphBatch):
        dt = self.compute_dtype
        x = self.sg_vocab_embedding.bag_sum(graph.node_tokens, dt)
        e = self.sg_vocab_embedding.bag_sum(graph.edge_tokens, dt)
        e = e * graph.edge_sym_sign[:, None].to(e.dtype)   # reverse-edge flip
        x = torch.where(graph.node_mask[:, None], x, 0.0)
        e = torch.where(graph.edge_mask[:, None], e, 0.0)
        x_enc, e_enc = self.scene_graph_encoding_layer(graph, x, e)
        x_enc = graph_layer_norm_any(
            graph, x_enc, self.graph_layer_norm.weight,
            self.graph_layer_norm.bias)
        return x_enc, e_enc


class QuestionEncoder(nn.Module):
    def __init__(self, emb_dim: int, hidden_dim: int = 512, num_heads: int = 8,
                 ffn_dim: int = 2048, num_layers: int = 3,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.emb_proj = TorchLinear(emb_dim, hidden_dim, dtype=dtype)
        self.pos_encoder = PositionalEncoding(hidden_dim, dropout=dropout)
        self.transformer_encoder = TransformerEncoder(
            num_layers, hidden_dim, num_heads, ffn_dim, dtype, dropout)

    def forward(self, tokens, text_embed: PaddedEmbed, generator=None):
        """tokens [B, L] -> memory [B, L, hidden_dim]."""
        x = self.emb_proj(text_embed(tokens)) * math.sqrt(self.hidden_dim)
        return self.transformer_encoder(self.pos_encoder(x, generator),
                                        generator)
