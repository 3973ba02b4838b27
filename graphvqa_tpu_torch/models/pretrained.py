"""Pretrained (GloVe) embedding injection (port of
``graphvqa_tpu/models/pretrained.py``), on the port's reference-named
parameters: ``text_vocab_embedding.weight`` (the shared text embedding, as
the reference copies GloVe into it) and, optionally,
``scene_graph_encoder.sg_vocab_embedding.weight`` (the reference's copy of
that one is commented out, so it trains from random init by default).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

TEXT = "text_vocab_embedding.weight"
SCENE = "scene_graph_encoder.sg_vocab_embedding.weight"


@torch.no_grad()
def inject_pretrained_embeddings(model: nn.Module,
                                 text_matrix: Optional[np.ndarray] = None,
                                 sg_matrix: Optional[np.ndarray] = None
                                 ) -> nn.Module:
    """Copy the given [vocab, dim] matrices into the model's embeddings in
    place (shapes must match) and return the model."""
    params = dict(model.named_parameters())
    for name, matrix in ((TEXT, text_matrix), (SCENE, sg_matrix)):
        if matrix is None:
            continue
        weight = params[name]
        if tuple(weight.shape) != tuple(matrix.shape):
            raise ValueError(f"{name} has shape {tuple(weight.shape)}, the "
                             f"matrix {tuple(matrix.shape)}")
        weight.copy_(torch.as_tensor(matrix, dtype=weight.dtype))
    return model
