"""The trainer's criteria (port of ``graphvqa_tpu/train/losses.py``).

``total_loss`` composes them as the JAX package does: short-answer
cross-entropy always; program, full-answer and execution-bitmap terms when
their flags are set and the model produced what they read. The GAT
configuration trains on the short-answer term alone.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch, in the logits' dtype."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


def masked_token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                               pad_idx: int) -> torch.Tensor:
    """Token cross-entropy [B, L, V] vs [B, L], averaged over non-pad
    targets (at least one)."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = -logp.gather(-1, targets.long()[..., None])[..., 0]
    mask = (targets != pad_idx).to(picked.dtype)
    return (picked * mask).sum() / mask.sum().clamp(min=1.0)


def bitmap_bce(bitmap_pred: torch.Tensor, bitmap_true: torch.Tensor,
               node_mask: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Binary cross-entropy of probabilities [N, steps] over real nodes."""
    p = bitmap_pred.clamp(eps, 1.0 - eps)
    per = -(bitmap_true * torch.log(p) + (1.0 - bitmap_true) * torch.log1p(-p))
    m = node_mask.to(per.dtype)
    denom = (m.sum() * per.shape[1]).clamp(min=1.0)
    return (per * m[:, None]).sum() / denom


def total_loss(out, programs_target, full_answers_target, short_answer_label,
               pad_idx: int, bitmap_true: Optional[torch.Tensor] = None,
               node_mask: Optional[torch.Tensor] = None,
               use_program_loss: bool = False,
               use_full_answer_loss: bool = False,
               use_bitmap_loss: bool = False
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, parts): ``parts`` holds each term and ``total``."""
    parts: Dict[str, torch.Tensor] = {}
    parts["short_answer"] = cross_entropy(out.short_answer_logits,
                                          short_answer_label)
    loss = parts["short_answer"]
    if use_program_loss and out.program_logits is not None:
        parts["program"] = masked_token_cross_entropy(
            out.program_logits, programs_target, pad_idx)
        loss = loss + parts["program"]
    if (use_full_answer_loss and out.full_answer_logits is not None
            and full_answers_target is not None):
        parts["full_answer"] = masked_token_cross_entropy(
            out.full_answer_logits, full_answers_target, pad_idx)
        loss = loss + parts["full_answer"]
    bitmap = getattr(out, "execution_bitmap", None)
    if use_bitmap_loss and bitmap is not None:
        parts["execution_bitmap"] = bitmap_bce(bitmap, bitmap_true, node_mask)
        loss = loss + parts["execution_bitmap"]
    parts["total"] = loss
    return loss, parts
