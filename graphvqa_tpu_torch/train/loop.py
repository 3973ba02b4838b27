"""The greedy-eval step (port of ``graphvqa_tpu/train/loop.py:make_eval_step``).

``make_eval_step(model, cfg)`` returns ``eval_step(batch)``: one request is
one :class:`QABatch` on the model's device; the answer is the per-row
signals of the JAX step (``vectors``), the greedy program tokens and the
pooling's node attention. This is the slice's serving entry point.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from graphvqa_tpu_torch.config import Config
from graphvqa_tpu_torch.core.graph import QABatch
from graphvqa_tpu_torch.models.pipeline import PipelineModel
from graphvqa_tpu_torch.train.metrics import program_match_vectors


def _teacher_inputs(batch: QABatch) -> QABatch:
    """programs[:, :-1] / full_answers[:, :-1], the teacher-forcing slice."""
    return dataclasses.replace(batch, programs=batch.programs[:, :-1],
                               full_answers=batch.full_answers[:, :-1])


def make_eval_step(model: PipelineModel, cfg: Config) -> Callable:
    pad = cfg.model.text.pad_idx
    steps = cfg.model.max_execution_steps

    @torch.inference_mode()
    def eval_step(batch: QABatch):
        """Greedy-decode validation -> (vectors, program_tokens,
        node_attention); rows are kept per sample so the caller can mask a
        ragged final batch."""
        out = model.sample(_teacher_inputs(batch))
        # sampled buffer vs the full target including <start>
        match, group_match, empty = program_match_vectors(
            out.program_tokens, batch.programs, pad, steps)
        logits = out.short_answer_logits
        sa_pred, sa_score = logits.argmax(dim=-1), logits.amax(dim=-1)
        vectors = dict(sa_pred=sa_pred, sa_score=sa_score,
                       program_match=match, program_group_match=group_match,
                       program_empty=empty)
        return vectors, out.program_tokens, out.node_attention

    return eval_step
