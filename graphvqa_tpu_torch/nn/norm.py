"""Masked BatchNorm over the concatenated node rows (port of
``graphvqa_tpu/nn/norm.py``).

Parameters and buffers carry ``nn.BatchNorm1d``'s names (weight, bias,
running_mean, running_var, num_batches_tracked), so the reference's
``gat_seq.bns.i`` entries load as they are. With ``use_running_average``
the running statistics normalize; without, the batch statistics of the real
rows do, in the JAX package's single pass (E[x^2] - E[x]^2 in float32), and
the running statistics move by momentum 0.1 towards the batch mean and the
*unbiased* batch variance (updated in place). Padded rows come out as 0; the
result is cast to ``dtype``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

MOMENTUM = 0.1          # of the running statistics (BatchNorm1d's default)


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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                use_running_average: bool = True) -> torch.Tensor:
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = self._batch_stats(x, mask)
        out = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        if mask is not None:
            out = torch.where(mask[:, None], out, 0.0)
        return out.to(self.compute_dtype)

    def _batch_stats(self, x, mask):
        """(mean, var) of the real rows, and the running-stat update."""
        xf = x.float()
        if mask is None:
            count = torch.full((), float(x.shape[0]), device=x.device)
            s1, s2 = xf.sum(dim=0), (xf * xf).sum(dim=0)
        else:
            m = mask.float()[:, None]
            count = m.sum().clamp(min=1.0)
            xm = xf * m
            s1, s2 = xm.sum(dim=0), (xm * xf).sum(dim=0)
        mean = s1 / count
        var = (s2 / count - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            unbiased = var * count / (count - 1.0).clamp(min=1.0)
            self.running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
            self.running_var.mul_(1 - MOMENTUM).add_(MOMENTUM * unbiased)
            self.num_batches_tracked += 1
        return mean, var
