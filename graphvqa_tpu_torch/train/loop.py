"""The train and eval loops (port of ``graphvqa_tpu/train/loop.py``).

``make_train_step(model, cfg)`` returns ``train_step(state, batch,
generator, ctx_generator=None)``: forward (dropout drawn from
``generator``, LCGN's context features from ``ctx_generator``, BatchNorm on
batch statistics), the loss, the backward, one Adam step with StepLR, the
running statistics' update and the in-step metrics (with the execution
engine, the bitmap's true and predicted positives), which stay on the
device. With
``steps_per_dispatch=K`` it takes a list of K batches and runs K steps in
order, reporting their metrics reduced as the JAX package's ``lax.scan``
dispatch does (counts summed, losses meaned, the last lr); the K steps are
exactly K single calls.

On the card both steps replay one CUDA graph per batch shape
(``train/graphs.py``), as the JAX package jits one program per ladder rung:
the first call at a shape is an eager warm-up, the second captures and
replays, later ones replay. A replay computes what the eager step computes
from the same state and generators. ``capture=False`` keeps the eager step;
on the CPU the step is eager. K steps per call are K replays of the one-step
graph: a replay is one host call already, and a K-step graph would be a
second graph per shape holding K static batches for no fewer launches on
the card.
``make_eval_step(model, cfg)`` returns ``eval_step(batch, generator=None)``:
one request is one :class:`QABatch` on the model's device; the answer is the
per-row signals of the JAX step (``vectors``, with ``execution_bitmap``
when the model has the execution engine), the greedy program tokens and the
pooling's node attention. ``generator`` draws LCGN's context features; an
lcgn model given none raises. ``train_one_epoch`` feeds batches to a train
step and prints meters (and can trace a window of steps with
torch.profiler); ``validate`` runs the eval step over batches, prints the
accuracies (and the bitmap's precision and recall) and writes the result
and attention dumps the official scorer reads.

With the program's tracing on (``core/profiling.py``) the train step
stamps the device segments ``loss_backward`` (the loss and the backward)
and ``optimizer`` (the step's metrics and Adam) after the model's own, and
the loops mark their waits for a batch (``gvqa.loop.next_batch``), the
meters' read-back (``gvqa.loop.meters``) and validation's host reads
(``gvqa.eval.readback``) as spans.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from graphvqa_tpu_torch.config import Config
from graphvqa_tpu_torch.core import profiling
from graphvqa_tpu_torch.core.graph import QABatch
from graphvqa_tpu_torch.models.pipeline import PipelineModel
from graphvqa_tpu_torch.nn.execution import bitmap_precision_recall
from graphvqa_tpu_torch.train.graphs import StepGraphs, map_tensors
from graphvqa_tpu_torch.train.logging_utils import (
    AverageMeter, ProgressMeter, synchronize_meters)
from graphvqa_tpu_torch.train.losses import total_loss
from graphvqa_tpu_torch.train.metrics import (
    program_match_vectors, program_string_exact_match_acc,
    reduce_scanned_metrics, topk_accuracy)
from graphvqa_tpu_torch.train.train_state import TrainState


def _teacher_inputs(batch: QABatch) -> QABatch:
    """programs[:, :-1] / full_answers[:, :-1], the teacher-forcing slice."""
    return dataclasses.replace(batch, programs=batch.programs[:, :-1],
                               full_answers=batch.full_answers[:, :-1])


def forward_backward(model: PipelineModel, cfg: Config, batch: QABatch,
                     generator: torch.Generator,
                     ctx_generator: Optional[torch.Generator] = None,
                     loss_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The part of a train step before the optimizer: forward (dropout from
    ``generator``, BatchNorm on batch statistics, which updates the running
    ones), the loss, the backward into each parameter's ``.grad`` (of the
    loss times ``loss_scale``) and the in-step metrics, on the device."""
    pad = cfg.model.text.pad_idx
    tc = cfg.train
    programs_target = batch.programs[:, 1:]
    full_answers_target = batch.full_answers[:, 1:]
    for p in model.parameters():
        p.grad = None
    # the full-answer decoder runs only when a loss reads it
    out = model(_teacher_inputs(batch), deterministic=False,
                use_running_average=False, generator=generator,
                ctx_generator=ctx_generator,
                full_answer=tc.use_full_answer_loss)
    loss, parts = total_loss(
        out, programs_target, full_answers_target,
        batch.short_answer_label, pad,
        bitmap_true=batch.graphs.exec_bitmap,
        node_mask=batch.graphs.node_mask,
        use_program_loss=tc.use_program_loss,
        use_full_answer_loss=tc.use_full_answer_loss,
        use_bitmap_loss=tc.use_bitmap_loss)
    (loss if loss_scale == 1.0 else loss * loss_scale).backward()
    profiling.stamp("loss_backward", batch.questions.device)
    with torch.no_grad():
        sa_correct, sa_total = topk_accuracy(
            out.short_answer_logits, batch.short_answer_label)
        prog_pred = out.program_logits.argmax(dim=-1)
        (p_c, p_t), (g_c, g_t), (ne_c, ne_t) = \
            program_string_exact_match_acc(prog_pred, programs_target,
                                           pad, cfg.model.max_execution_steps)
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics.update(
            short_answer_correct=sa_correct, short_answer_total=sa_total,
            program_correct=p_c, program_total=p_t,
            program_group_correct=g_c, program_group_total=g_t,
            program_nonempty_correct=ne_c, program_nonempty_total=ne_t,
            edge_count=batch.graphs.edge_mask.sum())
        if out.execution_bitmap is not None:
            tp, pred_total, _, true_total = bitmap_precision_recall(
                out.execution_bitmap, batch.graphs.exec_bitmap,
                batch.graphs.node_mask)
            metrics.update(bitmap_tp=tp, bitmap_pred_total=pred_total,
                           bitmap_true_total=true_total)
    return metrics


def multi_step(train_step: Callable, steps_per_dispatch: int) -> Callable:
    """K = ``steps_per_dispatch`` calls of ``train_step`` over a list of K
    batches, their metrics reduced as JAX's ``lax.scan`` dispatch reduces
    them (counts summed, losses meaned, the last lr)."""
    def run(state: TrainState, batches, generator: torch.Generator,
            ctx_generator: Optional[torch.Generator] = None):
        if len(batches) != steps_per_dispatch:
            raise ValueError(f"expected {steps_per_dispatch} batches, got "
                             f"{len(batches)}")
        per_step: Dict[str, list] = {}
        for batch in batches:
            state, m = train_step(state, batch, generator, ctx_generator)
            # copies: a replayed step's metrics are its graph's outputs,
            # which the next replay overwrites
            for k, v in m.items():
                per_step.setdefault(k, []).append(
                    v.clone() if isinstance(v, torch.Tensor) else v)
        return state, reduce_scanned_metrics(per_step)

    return run


def _graphs(model: torch.nn.Module, capture: bool) -> Optional[StepGraphs]:
    """The step's graphs when it replays them: with ``capture`` on the card
    (a model on the CPU runs eagerly)."""
    if capture and next(model.parameters()).device.type == "cuda":
        return StepGraphs()
    return None


def make_train_step(model: PipelineModel, cfg: Config,
                    steps_per_dispatch: int = 1,
                    capture: bool = True) -> Callable:
    """One optimizer step per call, or K = ``steps_per_dispatch`` steps over
    a list of K batches. The state is updated in place (the parameters,
    moments and running statistics are large) and returned. On the card each
    step replays its batch shape's CUDA graph (module doc; ``capture=False``
    keeps the eager step, the graphs are ``train_step.graphs``). After a
    step each parameter's ``.grad`` is that step's gradient (a replay points
    it at its graph's gradient tensors). A replayed step's metrics and
    gradients are its graph's outputs, which the next step overwrites: copy
    what is kept longer (``train_one_epoch`` does)."""

    def body(state: TrainState, batch: QABatch, generator, ctx_generator):
        metrics = forward_backward(model, cfg, batch, generator,
                                   ctx_generator)
        grads = {n: p.grad for n, p in model.named_parameters()}
        state.update(grads)
        profiling.stamp("optimizer", batch.questions.device)
        return metrics, grads

    graphs = _graphs(model, capture)

    def train_step(state: TrainState, batch: QABatch,
                   generator: torch.Generator,
                   ctx_generator: Optional[torch.Generator] = None):
        lr = state.current_lr()
        state.prepare()
        if graphs is None:
            metrics, _ = body(state, batch, generator, ctx_generator)
        else:
            metrics, grads = graphs(
                lambda b: body(state, b, generator, ctx_generator), batch,
                (generator, ctx_generator),
                bind=(state, state.opt_state, state.opt_state["count"],
                      state.lr_tensor))
            # a replay runs no Python: .grad may still point at the tensors
            # of an eager step or of another rung's graph
            for n, p in model.named_parameters():
                p.grad = grads[n]
        state.step += 1
        return state, dict(metrics, lr=lr)

    train_step.graphs = graphs
    if steps_per_dispatch <= 1:
        return train_step
    run = multi_step(train_step, steps_per_dispatch)
    run.graphs = graphs
    return run


def make_eval_step(model: PipelineModel, cfg: Config,
                   capture: bool = True) -> Callable:
    """The greedy-decode step (module doc). On the card each request
    replays its batch shape's CUDA graph, whose outputs are cloned: each
    answer is the caller's to keep. ``capture=False`` keeps the eager step
    (the graphs are ``eval_step.graphs``)."""
    pad = cfg.model.text.pad_idx
    steps = cfg.model.max_execution_steps

    def body(batch: QABatch, generator: Optional[torch.Generator]):
        out = model.sample(_teacher_inputs(batch), ctx_generator=generator)
        # sampled buffer vs the full target including <start>
        match, group_match, empty = program_match_vectors(
            out.program_tokens, batch.programs, pad, steps)
        logits = out.short_answer_logits
        sa_pred, sa_score = logits.argmax(dim=-1), logits.amax(dim=-1)
        vectors = dict(sa_pred=sa_pred, sa_score=sa_score,
                       program_match=match, program_group_match=group_match,
                       program_empty=empty)
        if out.execution_bitmap is not None:
            vectors["execution_bitmap"] = out.execution_bitmap
        return vectors, out.program_tokens, out.node_attention

    graphs = _graphs(model, capture)

    @torch.inference_mode()
    def eval_step(batch: QABatch,
                  generator: Optional[torch.Generator] = None):
        """Greedy-decode validation -> (vectors, program_tokens,
        node_attention); rows are kept per sample so the caller can mask a
        ragged final batch. ``generator`` draws LCGN's context features."""
        if graphs is None:
            return body(batch, generator)
        return map_tensors(torch.clone, graphs(
            lambda b: body(b, generator), batch, (generator,)))

    eval_step.graphs = graphs
    return eval_step


def train_one_epoch(train_step: Callable, state: TrainState, batches,
                    generator: torch.Generator, epoch: int,
                    print_freq: int = 100, num_batches: Optional[int] = None,
                    engine_rounds: int = 5, profile_dir: Optional[str] = None,
                    profile_steps: tuple = (5, 10),
                    ctx_generator: Optional[torch.Generator] = None
                    ) -> TrainState:
    """Run ``train_step`` over ``batches`` ((meta, batch) pairs), printing
    the loss, the accuracies and the throughput every ``print_freq`` steps.
    Each step's metrics are copied at once into a row of their own on the
    device (a step may hand back tensors that its next call overwrites, as
    a CUDA graph's outputs are) and stay there until a print boundary, which
    reads all the rows in one copy, so the host does not wait for each
    step. ``profile_dir`` traces steps
    [profile_steps) with torch.profiler (host and, on a GPU, the device)
    into ``profile_dir/trace.json``, a Chrome trace."""
    losses = AverageMeter("Loss", ":.4e")
    sa = AverageMeter("Acc@Short", ":6.2f")
    pa = AverageMeter("Acc@Program", ":6.2f")
    pg = AverageMeter("Acc@ProgramGroup", ":4.2f")
    pne = AverageMeter("Acc@ProgramNonEmpty", ":4.2f")
    progress = ProgressMeter(num_batches or 0, [losses, sa, pa, pg, pne],
                             prefix=f"Epoch: [{epoch}]")
    tput = profiling.ThroughputMeter(engine_rounds)
    pending = []

    def rate(correct, total):
        return 100.0 * float(correct) / max(int(total), 1)

    def keep(m):
        """This step's meter inputs as one float64 row of its own (exact
        for the float32 losses and the counts)."""
        pending.append(torch.stack([m[k].to(torch.float64)
                                    for k in _METER_KEYS]))

    def drain():
        with profiling.span("gvqa.loop.meters"):
            rows = torch.stack(pending).tolist() if pending else []
        for row in rows:
            m = dict(zip(_METER_KEYS, row))
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

    profiler = None
    i = -1
    it = iter(batches)
    while True:
        f0 = time.perf_counter()
        try:
            with profiling.span("gvqa.loop.next_batch"):
                _, batch = next(it)
        except StopIteration:
            break
        data_time += time.perf_counter() - f0
        i += 1
        if profile_dir is not None:
            if i == profile_steps[0]:
                profiler = _start_profiler()
            elif i == profile_steps[1] and profiler is not None:
                _stop_profiler(profiler, profile_dir)
                profiler = None
        state, m = train_step(state, batch, generator, ctx_generator)
        keep(m)
        if i % print_freq == 0:
            drain()
            progress.display(i)
            print(f"  throughput: {tput.summary()}, "
                  f"data-wait {wait_pct():.1f}%")
    if profiler is not None:
        _stop_profiler(profiler, profile_dir)
    drain()
    progress.display(i + 1)
    print(f"  epoch sustained: {tput.summary()}, data-wait {wait_pct():.1f}%"
          f" ({time.perf_counter() - epoch_t0:.1f}s wall)")
    return state


# the metrics train_one_epoch's meters read
_METER_KEYS = ("total", "short_answer_correct", "short_answer_total",
               "program_correct", "program_total", "program_group_correct",
               "program_group_total", "program_nonempty_correct",
               "program_nonempty_total", "edge_count")


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = pathlib.Path(profile_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))
    print(f"  profiler trace: {path / 'trace.json'}")


def _host(t: torch.Tensor) -> np.ndarray:
    """On the host as numpy (bfloat16 widened to float32, exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _print_qualitative(meta, batch, prog_np, sa_pred_np, text_vocab,
                       label2ans, real, max_steps, limit=8):
    """Decoded samples of the first batch: question, programs, answers."""
    M = max_steps
    programs_np = _host(batch.programs)
    questions_np = _host(batch.questions)
    for b in range(min(real, limit)):
        question = (meta["questions"][b] if meta.get("questions")
                    else text_vocab.decode(questions_np[b]))
        gt_progs = [text_vocab.decode(programs_np[s + M * b])
                    for s in range(M)]
        pred_progs = [text_vocab.decode(prog_np[s + M * b])
                      for s in range(M)]
        gt_progs = [s for s in gt_progs if s]
        pred_progs = [s for s in pred_progs if s]
        answer = meta["answers"][b] if meta.get("answers") else "?"
        pred = (label2ans[int(sa_pred_np[b])] if label2ans is not None
                else str(int(sa_pred_np[b])))
        print("=" * 16)
        print("question:", question)
        print("ground truth program:", " | ".join(gt_progs))
        print("predicted program:  ", " | ".join(pred_progs))
        print(f"answer: {answer}   prediction: {pred}")


def _attention_rows(meta, node_att_np, node_graph_np, scenes, real):
    """Per question: [x0, y0, x1, y1, att] per object, in the scene-graph
    conversion's sorted-object-id order, boxes relative to the image."""
    rows = []
    for b in range(real):
        scene = scenes.get(str(meta["image_ids"][b]), {})
        objects = scene.get("objects", {})
        if not objects:
            continue
        att = node_att_np[node_graph_np == b]
        w = float(scene.get("width", 1)) or 1.0
        h = float(scene.get("height", 1)) or 1.0
        boxes = []
        for k, oid in enumerate(sorted(objects.keys())):
            if k >= len(att):
                break
            o = objects[oid]
            boxes.append([o["x"] / w, o["y"] / h, (o["x"] + o["w"]) / w,
                          (o["y"] + o["h"]) / h, float(att[k])])
        rows.append({"questionId": str(meta["question_ids"][b]),
                     "attention": boxes})
    return rows


def validate(eval_step: Callable, batches, cfg: Config, text_vocab=None,
             label2ans=None, dump_path: Optional[str] = None,
             print_freq: int = 100,
             dump_attentions_path: Optional[str] = None,
             scenes: Optional[dict] = None,
             max_batches: Optional[int] = None,
             print_qualitative: bool = False,
             generator: Optional[torch.Generator] = None,
             mesh=None) -> Dict[str, float]:
    """Greedy-decode validation over ``batches`` ((meta, batch) pairs on the
    model's device): short-answer, program, program-group and non-empty
    program accuracies over the real rows of each batch (a ragged last
    batch's repeated rows are sliced off).

    ``dump_path`` writes the result dump (``{questionId: {...}}``, JSON with
    indent 4 and sorted keys); ``dump_attentions_path`` with ``scenes`` the
    object attention dump of the official grounding metric. ``max_batches``
    stops early (FAST_VALIDATE); ``print_qualitative`` prints decoded samples
    of the first batch; ``generator`` goes to the eval step (LCGN's draw).
    With the execution engine, the bitmap's precision and recall over the
    real graphs' nodes come back as ``bitmap_precision`` /
    ``bitmap_recall``.

    ``mesh`` (a :class:`~graphvqa_tpu_torch.parallel.mesh.Mesh`): each data
    rank evaluates its own shard of the batches (the ranks of one edge
    group the same one). The meters then synchronize over the data group at
    each print and at the end, so every rank returns the global averages
    and no question counts twice; the dumps are gathered over the data
    group and rank 0 writes them. The meters' synchronization is a
    collective whose call count follows ``print_freq`` and
    ``max_batches``, so they are checked equal on every rank first."""
    data_group = None
    if mesh is not None and mesh.size > 1:
        from graphvqa_tpu_torch.parallel.collectives import all_gather_host
        cfgs = all_gather_host((print_freq, max_batches), mesh.world_group)
        if any(c != cfgs[0] for c in cfgs):
            raise ValueError(
                f"validate() needs the same print_freq and max_batches on "
                f"every rank (got {cfgs}): its meter synchronization is a "
                f"collective whose call count depends on them")
        data_group = mesh.data_group
    write = mesh is None or mesh.is_main
    sa = AverageMeter("Acc@Short", ":6.2f")
    pa = AverageMeter("Acc@Program", ":6.2f")
    pg = AverageMeter("Acc@ProgramGroup", ":4.2f")
    pne = AverageMeter("Acc@ProgramNonEmpty", ":4.2f")
    bprec = AverageMeter("Bitmap@Precision", ":4.2f")
    brec = AverageMeter("Bitmap@Recall", ":4.2f")
    meters = [sa, pa, pg, pne, bprec, brec]
    progress = ProgressMeter(0, [sa, pa, pg, pne], prefix="Test: ")
    quesid2ans, attentions_out = {}, []
    M = cfg.model.max_execution_steps
    eval_t0 = time.perf_counter()
    total_real = 0

    i = -1
    it = iter(batches)
    while True:
        with profiling.span("gvqa.loop.next_batch"):
            item = next(it, None)
        if item is None:
            break
        i += 1
        if max_batches is not None and i >= max_batches:
            break
        meta, batch = item
        vec, prog_tokens, node_att = eval_step(batch, generator)
        real = meta.get("real_count", batch.questions.shape[0])
        total_real += real
        with profiling.span("gvqa.eval.readback"):
            sa_pred_np = _host(vec["sa_pred"])[:real]
            sa_score_np = _host(vec["sa_score"])[:real]
            prog_np = _host(prog_tokens)
            labels = _host(batch.short_answer_label)[:real]
            match = _host(vec["program_match"])[: real * M]
            gmatch = _host(vec["program_group_match"])[:real]
            empty = _host(vec["program_empty"])[: real * M]
        sa.update(100.0 * float((sa_pred_np == labels).sum()) / max(real, 1),
                  real)
        pa.update(100.0 * float(match.sum()) / max(real * M, 1), real * M)
        pg.update(100.0 * float(gmatch.sum()) / max(real, 1), real)
        nt = real * M - int(empty.sum())
        pne.update(100.0 * float(match.sum() - empty.sum()) / max(nt, 1), nt)
        if "execution_bitmap" in vec and real > 0:
            # over the real graphs' nodes only
            g = batch.graphs
            nmask = g.node_mask & (g.node_graph < real)
            tp, n_pred, _, n_true = (int(v) for v in bitmap_precision_recall(
                vec["execution_bitmap"], g.exec_bitmap, nmask))
            bprec.update(100.0 * tp / max(n_pred, 1), max(n_pred, 1))
            brec.update(100.0 * tp / max(n_true, 1), max(n_true, 1))

        if i == 0 and print_qualitative and text_vocab is not None:
            _print_qualitative(meta, batch, prog_np, sa_pred_np, text_vocab,
                               label2ans, real, M)
        if dump_path is not None and text_vocab is not None:
            gt_rows = text_vocab.decode_batch(
                _host(batch.programs)[: real * M])
            pred_rows = text_vocab.decode_batch(prog_np[: real * M])
            for b in range(real):
                qid = meta["question_ids"][b]
                gt_progs, pred_progs = [], []
                for s in range(M):
                    gt_sent = gt_rows[s + M * b]
                    pred_sent = pred_rows[s + M * b]
                    if not gt_sent and not pred_sent:
                        continue
                    gt_progs.append(gt_sent)
                    pred_progs.append(pred_sent)
                quesid2ans[str(qid)] = {
                    "questionId": str(qid),
                    "question": meta["questions"][b],
                    "ground_truth_program_list": gt_progs,
                    "predicted_program_list": pred_progs,
                    "answer": meta["answers"][b],
                    "prediction": label2ans[int(sa_pred_np[b])],
                    "prediction_score": "{:.2f}".format(float(sa_score_np[b])),
                    "types": meta["types"][b],
                }
        if dump_attentions_path is not None and scenes is not None:
            attentions_out += _attention_rows(
                meta, _host(node_att), _host(batch.graphs.node_graph), scenes,
                real)
        if i % print_freq == 0:
            synchronize_meters(meters, data_group)
            progress.display(i)
    # iter_batches gives every data shard the same number of batches, so
    # every rank reaches this collective equally often
    synchronize_meters(meters, data_group)
    progress.display(i + 1)
    wall = time.perf_counter() - eval_t0
    print(f"  eval sustained: {total_real / max(wall, 1e-9):.1f} qa/s "
          f"({total_real} questions, {wall:.1f}s wall)")

    # the other edge ranks hold the same dumps: only edge rank 0's gather
    if (data_group is not None and mesh.edge_rank == 0
            and (dump_path or dump_attentions_path)):
        from graphvqa_tpu_torch.parallel.collectives import all_gather_host
        gathered = all_gather_host((quesid2ans, attentions_out), data_group)
        quesid2ans, attentions_out = {}, []
        for qa, att in gathered:
            quesid2ans.update(qa)
            attentions_out.extend(att)
    if not write:
        dump_path = dump_attentions_path = None
    if dump_attentions_path is not None:
        path = pathlib.Path(dump_attentions_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(attentions_out))
        print("Attentions Dumped!", str(path))
    if dump_path is not None:
        path = pathlib.Path(dump_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(quesid2ans, indent=4, sort_keys=True))
        print("Result Dumped!", str(path))
    res = {"short_answer_acc": sa.avg, "program_acc": pa.avg,
           "program_group_acc": pg.avg, "program_nonempty_acc": pne.avg}
    if bprec.global_count:
        res["bitmap_precision"] = bprec.avg
        res["bitmap_recall"] = brec.avg
    return res
