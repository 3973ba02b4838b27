"""Metric kernels of the train and eval steps (port of
``graphvqa_tpu/train/metrics.py``). Each count comes back as a
(correct, denominator) pair of tensors on the inputs' device, so callers can
sum across batches before dividing."""
from __future__ import annotations

from typing import Tuple

import torch


def _count(n: int, device) -> torch.Tensor:
    """A static count as an int64 scalar made on ``device`` (a fill, not a
    copy from the host, so a CUDA graph can hold it)."""
    return torch.full((), n, dtype=torch.long, device=device)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, C] logits vs [B] labels -> (num_correct, batch)."""
    topi = logits.topk(k, dim=-1).indices
    correct = (topi == labels.long()[:, None]).any(dim=-1)
    return correct.sum(), _count(labels.shape[0], labels.device)


def _sequence_match(predictions, target, padding_idx: int) -> torch.Tensor:
    """[B, L] exact match per row: token equal or target is pad."""
    preds = predictions[:, :target.shape[1]]
    return ((preds == target) | (target == padding_idx)).all(dim=1)


def string_exact_match_acc(predictions, target, padding_idx: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    match = _sequence_match(predictions, target, padding_idx)
    return match.sum(), _count(target.shape[0], target.device)


def program_match_vectors(predictions, target, padding_idx: int = 1,
                          group_size: int = 5):
    """(match [B*M], group_match [B], empty_and_match [B*M]) bool tensors.
    An instruction whose target position 2 is already padding counts as
    empty, as in the reference."""
    match = _sequence_match(predictions, target, padding_idx)
    group_match = match.reshape(-1, group_size).all(dim=1)
    empty = (target[:, 2] == padding_idx) & match
    return match, group_match, empty


def program_string_exact_match_acc(predictions, target, padding_idx: int = 1,
                                   group_size: int = 5):
    """((instr_correct, instr_total), (group_correct, group_total),
    (non_empty_correct, non_empty_total)); see program_match_vectors."""
    match, group_match, empty = program_match_vectors(
        predictions, target, padding_idx, group_size)
    total = target.shape[0]
    dev = target.device
    n_empty = empty.sum()
    return ((match.sum(), _count(total, dev)),
            (group_match.sum(), _count(total // group_size, dev)),
            (match.sum() - n_empty, total - n_empty))


# Count-style metric keys, summed over the K steps of one
# ``make_train_step(steps_per_dispatch=K)`` call; the other keys are losses
# (meaned over equal-size batches) except lr (the last step's). "total" is
# the total loss, not a count.
SCAN_COUNT_KEYS = frozenset({
    "short_answer_correct", "short_answer_total", "program_correct",
    "program_total", "program_group_correct", "program_group_total",
    "program_nonempty_correct", "program_nonempty_total", "bitmap_tp",
    "bitmap_pred_total", "bitmap_true_total", "edge_count"})


def reduce_scanned_metrics(ms: dict) -> dict:
    """Reduce a dict of per-step lists of metrics (one entry per step of a
    K-step call) to the shape one step reports, as the JAX package reduces
    its ``lax.scan``'s stacked metrics."""
    out = {}
    for key, vals in ms.items():
        if key == "lr":
            out[key] = vals[-1]
        elif key in SCAN_COUNT_KEYS:
            out[key] = torch.stack(vals).sum(dim=0)
        else:
            out[key] = torch.stack(vals).mean(dim=0)
    return out
