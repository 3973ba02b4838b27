"""A training cell: the port's captured train step fed by its data path, as
``cli/train_cli.py`` drives it (``make_train_step``, or with several ranks
``make_dp_train_step``; ``GQADataset``'s shuffled, size-bucketed epochs of
this rank's shard through the fork pool, the prefetch thread,
``train_one_epoch``), over a closed loop of ``--seconds``.

Set-up builds the one train step with its model and Adam state and drives
it through its first steps on distinct batches of the main rung (an eager
warm-up, the capture with its replay, a replay), which the check holds to
the reference; then two steps of every other rung that the window's epochs
reach (every rank as many steps, the ones with fewer rungs taking more of
the main rung), so that the window holds replays only. The window starts
at epoch 0 and counts every step it issued; it ends when the last of them
has finished. Several ranks stop at the same step: rank 0 names it, a few
steps past its deadline, through a store every rank reads each step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import sys
import time

import torch

from harness import common
from harness.trace import NEXT_BATCH, Tracer, warm_up_profiler

CHECK_STEPS = 3
SHORTEST_STEP_S = 0.005     # bounds the epochs a window can reach
STOP_MARGIN = 16            # steps between rank 0's deadline and the stop


@dataclasses.dataclass
class Ranks:
    """This process's place among several ranks: the port's mesh, and a
    store that carries rank 0's stop to the others."""
    mesh: object
    store: object

    @property
    def rank(self) -> int:
        return self.mesh.rank


class Feed:
    """The epoch's batches until the stop: marks the wait for each with the
    span the trace reads, keeps each batch's meta and drives the tracer."""

    def __init__(self, batches, stop, run, tracer):
        self.batches, self.stop, self.run = batches, stop, run
        self.tracer, self.stopped = tracer, False

    def __iter__(self):
        from torch.profiler import record_function
        while True:
            if self.stop(len(self.run.metas)):
                self.stopped = True
                return
            with record_function(NEXT_BATCH):
                item = next(self.batches, None)
            if item is None:
                return
            if self.tracer is not None:
                self.tracer.step(len(self.run.metas), item[0])
            self.run.metas.append(item[0])
            yield item


def rank_seed(seed: int, data_rank: int) -> int:
    """The generators' seed of a data rank (the CLI's convention)."""
    return seed + 1_000_003 * data_rank


def stopper(deadline: float, ranks):
    """-> stop(step): True once the window is over. One rank: the deadline
    on the host clock. Several: rank 0 names the stop step when its
    deadline passes; every rank stops there."""
    if ranks is None:
        return lambda i: time.perf_counter() >= deadline
    at = []

    def stop(i):
        if not at:
            if ranks.rank == 0 and time.perf_counter() >= deadline:
                at.append(i + STOP_MARGIN)
                ranks.store.set("stop", str(at[0]))
            elif ranks.rank != 0 and ranks.store.check(["stop"]):
                at.append(int(ranks.store.get("stop")))
        return bool(at) and i >= at[0]
    return stop


def shard(ranks) -> dict:
    if ranks is None:
        return {}
    return dict(shard_index=ranks.mesh.data_rank, num_shards=ranks.mesh.data)


def window_shapes(s, seed, seconds, n_data=1, rank=0) -> tuple:
    """(the orders of the epochs the window can reach, the rung of each of
    their batches), of data rank ``rank``'s shard of ``n_data``."""
    cfg, tr = s.cfg, s.traffic
    n = n_data
    kw = {} if n_data == 1 else dict(shard_index=rank, num_shards=n_data)
    steps_per_epoch = len(s.dataset) // n // cfg.batch.num_graphs
    epochs = math.ceil(seconds / SHORTEST_STEP_S / steps_per_epoch) + 1
    sizes = s.reader.row_sizes()
    base = (cfg.batch.nodes_per_graph, cfg.batch.edges_per_graph)
    from reference.inputs import rung
    orders, shapes = [], []
    for e in range(epochs):
        order = s.dataset.batch_order(
            cfg.batch, shuffle=True, seed=seed + e, drop_last=True,
            size_bucket_windows=tr["size_bucket"], **kw)
        orders.append(order)
        shapes.append([(rung(base[0], int(sizes[idx, 0].max())),
                        rung(base[1], int(sizes[idx, 1].max())))
                       for idx in order])
    return orders, shapes


def setup_batches(orders, shapes, base) -> list:
    """(rung, index array) of the set-up steps: the first CHECK_STEPS
    batches of the main rung, then the first two of every other rung
    reached."""
    main = [o for o, sh in zip(orders[0], shapes[0]) if sh == base]
    out = [(base, idx) for idx in main[:CHECK_STEPS]]
    seen = {}
    for order, shape in zip(orders, shapes):
        for idx, sh in zip(order, shape):
            if sh != base and len(seen.setdefault(sh, [])) < 2:
                seen[sh].append(idx)
    for sh in sorted(seen):
        out += [(sh, idx) for idx in seen[sh]]
    if len(out) < CHECK_STEPS or out[CHECK_STEPS - 1][0] != base:
        raise RuntimeError("epoch 0 holds fewer than three batches of the "
                           "main rung")
    return out, main


def plan_steps(s, seed, seconds, n_data=1) -> list:
    """Every data rank's set-up steps, as many on each."""
    base = (s.cfg.batch.nodes_per_graph, s.cfg.batch.edges_per_graph)
    plans = [setup_batches(*window_shapes(s, seed, seconds, n_data, r), base)
             for r in range(n_data)]
    longest = max(len(p) for p, _ in plans)
    out = []
    for plan, main in plans:
        extra = main[CHECK_STEPS:CHECK_STEPS + longest - len(plan)]
        out.append(plan + [(base, idx) for idx in extra])
        if len(out[-1]) != longest:
            raise RuntimeError("a shard lacks main-rung batches for set-up")
    return out


def run(s, seed: int, seconds: float, trace: bool, device, t_start: float,
        hooks=None, ranks: Ranks = None) -> common.Window:
    from graphvqa_tpu_torch.data.dataset import MAX_EXECUTION_STEP, build_batch
    from graphvqa_tpu_torch.data.prefetch import prefetch
    from graphvqa_tpu_torch.train.loop import make_train_step, train_one_epoch
    from graphvqa_tpu_torch.train.train_state import B1, create_train_state
    cfg, tr = s.cfg, s.traffic
    tc = cfg.train
    common.stamp("traffic ready", t_start)
    model, weights = common.build_model(cfg, seed + 1, device)
    shapes = common.leaf_shapes(model)
    common.stamp("model built", t_start)
    state = create_train_state(model, lr=tc.lr, lr_drop=tc.lr_drop,
                               lr_gamma=tc.lr_gamma,
                               weight_decay=tc.weight_decay)
    if ranks is None:
        seeds = (seed + 3, seed + 2)
        step = make_train_step(model, cfg)
    else:
        from graphvqa_tpu_torch.parallel.data_parallel import (
            make_dp_train_step)
        r = ranks.mesh.data_rank
        seeds = (rank_seed(seed + 3, r), rank_seed(seed + 2, r))
        step = make_dp_train_step(model, cfg, ranks.mesh)
    gen = torch.Generator(device=device).manual_seed(seeds[0])
    ctx = torch.Generator(device=device).manual_seed(seeds[1])
    if hooks is not None:
        step = hooks.train_step(step)

    n_data = ranks.mesh.data if ranks is not None else 1
    plans = plan_steps(s, seed, seconds, n_data)
    plan = plans[ranks.mesh.data_rank if ranks is not None else 0]
    # per step, every data rank's (rows, rung)
    check = dict(steps=[[p[k] for p in plans] for k in range(CHECK_STEPS)],
                 losses=[])
    for k, (_, idx) in enumerate(plan):
        _, batch = build_batch(s.dataset, idx, cfg.batch, MAX_EXECUTION_STEP)
        state, m = step(state, batch.to(device), gen, ctx)
        if k < CHECK_STEPS:
            check["losses"].append(m["total"].detach().clone())
        if k == 0:
            check["grad_norms"] = {
                n: torch.linalg.vector_norm(mu / (1.0 - B1))
                for n, mu in state.opt_state["mu"].items()}
            # the first gradient itself, on the host until the check
            check["grads"] = {n: (mu / (1.0 - B1)).cpu()
                              for n, mu in state.opt_state["mu"].items()}
        if k == CHECK_STEPS - 1:
            # each leaf's change, on the host until the check
            check["changes"] = {n: (p.detach() - weights[n]).cpu()
                                for n, p in model.named_parameters()}
            del weights

    common.stamp(f"{len(plan)} set-up steps done", t_start)
    steps_per_epoch = len(s.dataset) // n_data // cfg.batch.num_graphs

    def batches(epoch):
        """The CLI's feed of one epoch: this rank's shard of the shuffled,
        size-bucketed order through the worker pool, each batch copied to
        the card."""
        it = s.dataset.iter_batches(
            cfg.batch, shuffle=True, seed=seed + epoch, drop_last=True,
            num_workers=tr["workers"], size_bucket_windows=tr["size_bucket"],
            **shard(ranks))
        for m, b in it:
            yield m, b.to(device)

    epoch = 0
    feed = prefetch(batches(epoch), depth=tr["prefetch"])
    # the first batch in set-up: the pool forks and the thread fills
    feed = itertools.chain([next(feed)], feed)
    graphs = getattr(step, "graphs", None)
    warm_before = graphs.warm_ups if graphs is not None else 0
    out = common.Window(mode="train")
    if trace:
        warm_up_profiler(device.type == "cuda")
    common.sync(device)
    if ranks is not None:
        torch.distributed.barrier()
    out.setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    tracer = Tracer(out, t0, tr["trace_at"] * seconds, tr["trace_steps"],
                    device.type == "cuda") if trace else None
    stop = stopper(t0 + seconds, ranks)
    gc_meter = common.GCMeter().start()
    while True:
        state.epoch = epoch
        f = Feed(feed, stop, out, tracer)
        with contextlib.redirect_stdout(sys.stderr):
            state = train_one_epoch(
                step, state, f, gen, epoch, print_freq=tc.print_freq,
                num_batches=steps_per_epoch,
                engine_rounds=cfg.model.engine.num_rounds,
                ctx_generator=ctx)
        if f.stopped:
            break
        epoch += 1
        feed = prefetch(batches(epoch), depth=tr["prefetch"])
    common.sync(device)
    out.window_s = time.perf_counter() - t0
    gc_meter.stop()
    out.steps = len(out.metas)
    out.host_s, out.host_steps = out.window_s, out.steps
    if tracer is not None:
        tracer.finish()
        out.trace = tracer.summary
        out.trace_metas = tracer.metas
        if tracer.host is not None:
            out.host_s, out.host_steps = tracer.host
    out.questions = sum(m["real_count"] for m in out.metas) * n_data
    out.compiled_in_window = (graphs.warm_ups - warm_before
                              if graphs is not None else 0)
    out.memory_peak = common.memory_peak(device)
    s.dataset.close()
    del step, state, model, graphs
    common.free(device)
    out.check = check
    out.shapes = shapes
    return out
