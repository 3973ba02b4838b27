"""A validation cell: the port's captured eval step (greedy program and
full-answer decoding) over the validation split in file order, as
``cli/train_cli.py``'s ``validate`` reads it (``iter_batches`` through the
fork pool, each batch copied to the card), passes repeated until
``--seconds`` have gone by, each batch's answers read back to the host.

A batch is timed from the moment the loop hands it to the eval step until
its answers are on the host. Set-up warms up and captures every rung a
pass reaches. The check compares what two batches of the first pass, one
drawn from the seed and the one on the largest rung, were served with the
reference: the short answers with the short-answer logits they were taken
from, and the greedy program and full-answer tokens.
"""
from __future__ import annotations

import time

import numpy as np

from harness import common
from harness.trace import NEXT_BATCH, Tracer, warm_up_profiler


def checked_positions(shapes, seed) -> list:
    """Two batch positions of a pass: one drawn from the seed and the one
    on the largest rung (the next drawn one when they coincide)."""
    rng = np.random.default_rng(seed)
    largest = max(range(len(shapes)),
                  key=lambda i: (shapes[i][0] * shapes[i][1], -i))
    for drawn in rng.permutation(len(shapes)):
        if int(drawn) != largest:
            return [int(drawn), largest]
    return [largest]


def hooked(served, batch) -> dict:
    """What the hook kept of the step that served ``batch``, on the host."""
    g = batch.graphs
    fa, logits = served[(g.nodes_per_graph, g.edges_per_graph)]
    return dict(full_answer_tokens=fa.cpu().numpy(),
                sa_logits=logits.float().cpu().numpy())


def run(s, seed: int, seconds: float, trace: bool, device, t_start: float,
        hooks=None) -> common.Window:
    from graphvqa_tpu_torch.data.dataset import MAX_EXECUTION_STEP, build_batch
    from graphvqa_tpu_torch.train.loop import make_eval_step
    cfg, tr = s.cfg, s.traffic
    common.stamp("traffic ready", t_start)
    model, weights = common.build_model(cfg, seed + 1, device)
    shapes = common.leaf_shapes(model)
    common.stamp("model built", t_start)
    del weights
    # the full-answer tokens and the short-answer logits of the last sample
    # at each rung: the eval step returns the program tokens and the short
    # answers, and these come back through this hook (a replay writes them
    # where its capture put them)
    served = {}
    sample = model.sample

    def keep_served(batch, ctx_generator=None):
        out = sample(batch, ctx_generator=ctx_generator)
        g = batch.graphs
        served[(g.nodes_per_graph, g.edges_per_graph)] = (
            out.full_answer_tokens, out.short_answer_logits)
        return out

    model.sample = keep_served
    step = make_eval_step(model, cfg)
    if hooks is not None:
        step = hooks.eval_step(step)

    order = s.dataset.batch_order(cfg.batch)
    base = (cfg.batch.nodes_per_graph, cfg.batch.edges_per_graph)
    rungs = [s.reader.shape(idx, *base) for idx in order]
    for sh in sorted(set(rungs)):
        idx = order[rungs.index(sh)]
        _, batch = build_batch(s.dataset, idx, cfg.batch, MAX_EXECUTION_STEP)
        for _ in range(2):              # the eager warm-up, the capture
            step(batch.to(device))
    common.stamp(f"{len(set(rungs))} shapes warmed up and captured", t_start)
    positions = checked_positions(rungs, seed)
    check = dict(rows=[order[p] for p in positions],
                 rungs=[rungs[p] for p in positions], outputs={})

    def batches():
        for m, b in s.dataset.iter_batches(cfg.batch,
                                           num_workers=tr["workers"]):
            yield m, b.to(device)

    graphs = getattr(step, "graphs", None)
    warm_before = graphs.warm_ups if graphs is not None else 0
    out = common.Window(mode="eval")
    it = batches()
    first = next(it)                    # forks the pool in set-up
    if trace:
        warm_up_profiler(device.type == "cuda")
    common.sync(device)
    out.setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    tracer = Tracer(out, t0, tr["trace_at"] * seconds, tr["trace_steps"],
                    device.type == "cuda") if trace else None
    deadline = t0 + seconds
    position = 0
    from torch.profiler import record_function
    gc_meter = common.GCMeter().start()
    while time.perf_counter() < deadline:
        with record_function(NEXT_BATCH):
            item = first if first is not None else next(it, None)
        first = None
        if item is None:                # the next pass
            it, position = batches(), 0
            continue
        meta, batch = item
        if tracer is not None:
            tracer.step(len(out.metas), meta)
        h0 = time.perf_counter()
        vec, prog, _ = step(batch)
        answers = {k: v.float().cpu().numpy() for k, v in vec.items()}
        answers["program_tokens"] = prog.cpu().numpy()
        out.batch_s.append(time.perf_counter() - h0)
        out.metas.append(meta)
        if position in positions and position not in check["outputs"]:
            check["outputs"][position] = dict(
                answers, **hooked(served, batch))
        position += 1
    common.sync(device)
    out.window_s = time.perf_counter() - t0
    gc_meter.stop()
    # a checked batch that the window did not reach is served after it
    # closes, untimed, by the same step
    while len(check["outputs"]) < len(positions):
        item = next(it, None)
        if item is None:
            it, position = batches(), 0
            continue
        if position in positions and position not in check["outputs"]:
            vec, prog, _ = step(item[1])
            check["outputs"][position] = dict(
                sa_pred=vec["sa_pred"].cpu().numpy(),
                program_tokens=prog.cpu().numpy(), **hooked(served, item[1]))
        position += 1
    out.steps = len(out.metas)
    out.host_s, out.host_steps = out.window_s, out.steps
    if tracer is not None:
        tracer.finish()
        out.trace = tracer.summary
        out.trace_metas = tracer.metas
        if tracer.host is not None:
            out.host_s, out.host_steps = tracer.host
    out.questions = sum(m["real_count"] for m in out.metas)
    out.compiled_in_window = (graphs.warm_ups - warm_before
                              if graphs is not None else 0)
    out.memory_peak = common.memory_peak(device)
    s.dataset.close()
    check["outputs"] = [check["outputs"].get(p) for p in positions]
    del step, model, graphs, served
    common.free(device)
    out.check = check
    out.shapes = shapes
    return out
