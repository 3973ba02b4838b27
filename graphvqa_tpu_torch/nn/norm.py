"""Masked BatchNorm over the concatenated node rows (port of
``graphvqa_tpu/nn/norm.py``), running-average branch only.

Parameters and buffers carry ``nn.BatchNorm1d``'s names (weight, bias,
running_mean, running_var, num_batches_tracked), so the reference's
``gat_seq.bns.i`` entries load as they are. Padded rows come out as 0; the
result is cast to ``dtype``. Batch statistics belong to the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.compute_dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = ((x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
               * self.weight + self.bias)
        if mask is not None:
            out = torch.where(mask[:, None], out, 0.0)
        return out.to(self.compute_dtype)
