"""Per-row program match signals (port of
``graphvqa_tpu/train/metrics.py:program_match_vectors``)."""
from __future__ import annotations

import torch


def _sequence_match(predictions, target, padding_idx: int) -> torch.Tensor:
    """[B, L] exact match per row: token equal or target is pad."""
    preds = predictions[:, :target.shape[1]]
    return ((preds == target) | (target == padding_idx)).all(dim=1)


def program_match_vectors(predictions, target, padding_idx: int = 1,
                          group_size: int = 5):
    """(match [B*M], group_match [B], empty_and_match [B*M]) bool tensors.
    An instruction whose target position 2 is already padding counts as
    empty, as in the reference."""
    match = _sequence_match(predictions, target, padding_idx)
    group_match = match.reshape(-1, group_size).all(dim=1)
    empty = (target[:, 2] == padding_idx) & match
    return match, group_match, empty
