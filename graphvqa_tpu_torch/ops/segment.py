"""Segment ops of the flat layout as plain PyTorch (port of
``graphvqa_tpu/ops/segment.py``, which runs them as XLA ops with no Pallas
kernel): sums, means, maxes and the softmax over segments of rows, the
per-edge gather and the edge-to-node scatter.

Masked lanes add 0 to sums and -1e30 to maxes; masked softmax lanes are 0.
Sums accumulate in float32 and come back in the values' dtype. The softmax
keeps the JAX function's numerics: the segment max is not detached (its
gradient flows, as in JAX), masked lanes are set to 0 before ``exp`` so no
inf or NaN enters a backward, ``exp`` takes ``minimum(shifted, 0)`` (whose
derivative at a tie is 1/2 in both frameworks) and the denominator gets
``+1e-16`` (torch_geometric's softmax).
"""
from __future__ import annotations

from typing import Optional

import torch

from graphvqa_tpu_torch.ops.dense import NEG_INF, SOFTMAX_EPS


def _mask_up(mask: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A [E] mask broadcastable against [E, ...] values."""
    return mask.reshape(mask.shape + (1,) * (ref.ndim - mask.ndim))


def _index(segment_ids: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return segment_ids.long().reshape(
        segment_ids.shape + (1,) * (ref.ndim - 1)).expand_as(ref)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Sum of ``values`` rows per segment (torch_scatter.scatter_add)."""
    if mask is not None:
        values = torch.where(_mask_up(mask, values), values, 0)
    out = torch.zeros((num_segments,) + values.shape[1:], dtype=torch.float32,
                      device=values.device)
    return out.index_add(0, segment_ids, values.float()).to(values.dtype)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Mean per segment (torch_scatter.scatter_mean); empty segments 0."""
    ones = (mask.to(values.dtype) if mask is not None
            else torch.ones(segment_ids.shape, dtype=values.dtype,
                            device=values.device))
    total = segment_sum(values, segment_ids, num_segments, mask)
    count = segment_sum(ones, segment_ids, num_segments).clamp(min=1.0)
    return total / count.reshape(count.shape + (1,) * (total.ndim - 1))


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Max per segment; empty segments hold -inf."""
    if mask is not None:
        values = torch.where(_mask_up(mask, values), values, NEG_INF)
    out = torch.full((num_segments,) + values.shape[1:], float("-inf"),
                     dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, _index(segment_ids, values), values,
                              reduce="amax", include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Softmax within each segment (torch_geometric.utils.softmax)."""
    seg_max = segment_max(logits, segment_ids, num_segments, mask)
    shifted = logits - seg_max.index_select(0, segment_ids)
    if mask is not None:
        shifted = torch.where(_mask_up(mask, shifted), shifted, 0.0)
    expd = torch.exp(torch.minimum(shifted, torch.zeros_like(shifted)))
    if mask is not None:
        expd = torch.where(_mask_up(mask, expd), expd, 0.0)
    denom = segment_sum(expd, segment_ids, num_segments)
    out = expd / (denom.index_select(0, segment_ids) + SOFTMAX_EPS)
    if mask is not None:
        out = torch.where(_mask_up(mask, out), out, 0.0)
    return out


def gather_nodes(node_values: torch.Tensor,
                 edge_index: torch.Tensor) -> torch.Tensor:
    """Per-edge gather ``x[edge_index]``."""
    return node_values.index_select(0, edge_index)


def scatter_edges_to_nodes(edge_values: torch.Tensor, edge_dst: torch.Tensor,
                           num_nodes: int,
                           edge_mask: Optional[torch.Tensor] = None,
                           reduce: str = "sum") -> torch.Tensor:
    """Sum (or mean) of per-edge values into their destination nodes."""
    if reduce == "sum":
        return segment_sum(edge_values, edge_dst, num_nodes, edge_mask)
    if reduce == "mean":
        return segment_mean(edge_values, edge_dst, num_nodes, edge_mask)
    raise ValueError(f"unknown reduce: {reduce}")
