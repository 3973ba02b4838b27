"""Token embedding with a hard-zero padding row (port of
``graphvqa_tpu/nn/embedding.py``).

The pad token embeds to an exact zero vector whatever the table holds: the
lookup is multiplied by a pad mask. ``bag_sum`` sums each row's token
embeddings over the slot axis; the JAX package writes it as an [N, V] counts
matmul (a TPU workaround for serialized gathers), here it is a sum-mode
embedding bag, with the same rounding: the table is cast to the compute dtype
first and the sum accumulates in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class PaddedEmbed(nn.Module):
    def __init__(self, vocab_size: int, features: int, pad_idx: int = 1):
        super().__init__()
        self.pad_idx = pad_idx
        self.weight = nn.Parameter(torch.empty(vocab_size, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids.long(), self.weight)
        return out * (ids != self.pad_idx)[..., None].to(out.dtype)

    def bag_sum(self, ids: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[N, T] token ids -> [N, D] sum of their embeddings (pad excluded)."""
        table = self.weight.to(compute_dtype).float()
        out = F.embedding_bag(ids.long(), table, mode="sum",
                              padding_idx=self.pad_idx)
        return out.to(compute_dtype)
