"""The train and greedy-eval steps (port of ``graphvqa_tpu/train/loop.py``).

``make_train_step(model, cfg)`` returns ``train_step(state, batch,
generator)``: forward (dropout drawn from ``generator``, BatchNorm on batch
statistics), the loss, the backward, one Adam step with StepLR, the running
statistics' update and the in-step metrics, which stay on the device.
``make_eval_step(model, cfg)`` returns ``eval_step(batch)``: one request is
one :class:`QABatch` on the model's device; the answer is the per-row
signals of the JAX step (``vectors``), the greedy program tokens and the
pooling's node attention. ``train_one_epoch`` feeds batches to a train step
and prints meters. (The JAX package's multi-step dispatch and ``validate``
with its result dump are not ported yet.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from graphvqa_tpu_torch.config import Config
from graphvqa_tpu_torch.core.graph import QABatch
from graphvqa_tpu_torch.models.pipeline import PipelineModel
from graphvqa_tpu_torch.train.logging_utils import AverageMeter, ProgressMeter
from graphvqa_tpu_torch.train.losses import total_loss
from graphvqa_tpu_torch.train.metrics import (
    program_match_vectors, program_string_exact_match_acc, topk_accuracy)
from graphvqa_tpu_torch.train.profiling import ThroughputMeter
from graphvqa_tpu_torch.train.train_state import TrainState


def _teacher_inputs(batch: QABatch) -> QABatch:
    """programs[:, :-1] / full_answers[:, :-1], the teacher-forcing slice."""
    return dataclasses.replace(batch, programs=batch.programs[:, :-1],
                               full_answers=batch.full_answers[:, :-1])


def make_train_step(model: PipelineModel, cfg: Config) -> Callable:
    """One optimizer step per call. The state is updated in place (the
    parameters, moments and running statistics are large) and returned."""
    pad = cfg.model.text.pad_idx
    steps = cfg.model.max_execution_steps
    tc = cfg.train

    def train_step(state: TrainState, batch: QABatch,
                   generator: torch.Generator):
        programs_target = batch.programs[:, 1:]
        full_answers_target = batch.full_answers[:, 1:]
        for p in model.parameters():
            p.grad = None
        # the full-answer decoder runs only when a loss reads it
        out = model(_teacher_inputs(batch), deterministic=False,
                    use_running_average=False, generator=generator,
                    full_answer=tc.use_full_answer_loss)
        loss, parts = total_loss(
            out, programs_target, full_answers_target,
            batch.short_answer_label, pad,
            bitmap_true=batch.graphs.exec_bitmap,
            node_mask=batch.graphs.node_mask,
            use_program_loss=tc.use_program_loss,
            use_full_answer_loss=tc.use_full_answer_loss,
            use_bitmap_loss=tc.use_bitmap_loss)
        loss.backward()
        lr = state.current_lr()
        state.apply_gradients({n: p.grad for n, p in model.named_parameters()})
        with torch.no_grad():
            sa_correct, sa_total = topk_accuracy(
                out.short_answer_logits, batch.short_answer_label)
            prog_pred = out.program_logits.argmax(dim=-1)
            (p_c, p_t), (g_c, g_t), (ne_c, ne_t) = \
                program_string_exact_match_acc(prog_pred, programs_target,
                                               pad, steps)
            metrics = {k: v.detach() for k, v in parts.items()}
            metrics.update(
                short_answer_correct=sa_correct, short_answer_total=sa_total,
                program_correct=p_c, program_total=p_t,
                program_group_correct=g_c, program_group_total=g_t,
                program_nonempty_correct=ne_c, program_nonempty_total=ne_t,
                lr=lr, edge_count=batch.graphs.edge_mask.sum())
        return state, metrics

    return train_step


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


def train_one_epoch(train_step: Callable, state: TrainState, batches,
                    generator: torch.Generator, epoch: int,
                    print_freq: int = 100, num_batches: Optional[int] = None,
                    engine_rounds: int = 5) -> TrainState:
    """Run ``train_step`` over ``batches`` ((meta, batch) pairs), printing
    the loss, the accuracies and the throughput every ``print_freq`` steps.
    The metric dicts stay on the device until a print boundary, so the host
    does not wait for each step."""
    losses = AverageMeter("Loss", ":.4e")
    sa = AverageMeter("Acc@Short", ":6.2f")
    pa = AverageMeter("Acc@Program", ":6.2f")
    pg = AverageMeter("Acc@ProgramGroup", ":4.2f")
    pne = AverageMeter("Acc@ProgramNonEmpty", ":4.2f")
    progress = ProgressMeter(num_batches or 0, [losses, sa, pa, pg, pne],
                             prefix=f"Epoch: [{epoch}]")
    tput = ThroughputMeter(engine_rounds)
    pending = []

    def rate(correct, total):
        return 100.0 * float(correct) / max(int(total), 1)

    def drain():
        for m in pending:
            m = {k: float(v) for k, v in m.items()}
            bsz = int(m["short_answer_total"])
            tput.update(bsz, int(m["edge_count"]))
            losses.update(m["total"], bsz)
            sa.update(rate(m["short_answer_correct"], bsz), bsz)
            pt = int(m["program_total"])
            pa.update(rate(m["program_correct"], pt), pt)
            gt = int(m["program_group_total"])
            pg.update(rate(m["program_group_correct"], gt), gt)
            nt = int(m["program_nonempty_total"])
            pne.update(rate(m["program_nonempty_correct"], nt), nt)
        pending.clear()

    # the share of wall time the host spends waiting for the input pipeline
    data_time = 0.0
    epoch_t0 = time.perf_counter()

    def wait_pct():
        return 100.0 * data_time / max(time.perf_counter() - epoch_t0, 1e-9)

    i = -1
    it = iter(batches)
    while True:
        f0 = time.perf_counter()
        try:
            _, batch = next(it)
        except StopIteration:
            break
        data_time += time.perf_counter() - f0
        i += 1
        state, m = train_step(state, batch, generator)
        pending.append(m)
        if i % print_freq == 0:
            drain()
            progress.display(i)
            print(f"  throughput: {tput.summary()}, "
                  f"data-wait {wait_pct():.1f}%")
    drain()
    progress.display(i + 1)
    print(f"  epoch sustained: {tput.summary()}, data-wait {wait_pct():.1f}%"
          f" ({time.perf_counter() - epoch_t0:.1f}s wall)")
    return state
