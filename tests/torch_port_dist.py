"""Spawned ranks of the port's multi-rank tests, importing no JAX (spawned
children re-import this module, and the card's machine has no JAX).

``spawn(world, workdir, plan, device)`` starts ``world`` processes that
join one gloo process group on a ``file://`` store under ``workdir`` (no
port to collide under xdist) and run every case of ``plan`` in order, each
on its own (data, edge) mesh of the world; every rank saves its results to
``workdir/rank<r>.pt``. A case is a dict with ``kind`` ('train', 'eval' or
'validate'), ``data`` and ``edge`` and the kind's inputs, all on the CPU:

  * train: ``cfg`` (the port's Config), ``state_dict``, ``lr``, ``wd``,
    ``batches`` (per data rank, a list of batches), optional ``k`` (steps
    per call, default every batch in one call), optional ``capture``
    (the step replays graphs through :class:`FakeCapture`, installed in
    the rank), optional LCGN ``noise``; the result: parameters, Adam
    moments, running statistics, the last call's metrics and every call's,
    this rank's own gradients, its shard's edges_per_graph, each call's
    ``dist.all_reduce`` calls (their number, and each one's op, shape and
    dtype in order) and the step graphs' (warm-ups, captures, replays),
    segments per key and FakeCapture's cuts and modes;
  * eval: ``cfg``, ``state_dict``, ``batch``, optional ``capture`` and
    ``requests`` (calls of the step on the batch, default 1); the last
    request's outputs, every request's, their ``dist.all_reduce`` calls
    and the graphs' record as for train;
  * validate: ``cfg``, ``state_dict``, ``data_root``, ``split``,
    ``batch_size`` and ``out`` (a directory for rank 0's dumps); the
    result dict of ``validate``.
"""
from __future__ import annotations

import contextlib
import functools
import pathlib

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def start(world: int, workdir, plan, device: str = "cpu"):
    """Start ``world`` gloo ranks on ``plan`` and return at once (the
    caller computes its references meanwhile); :func:`collect` joins."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(plan, workdir / "plan.pt")
    ctx = mp.start_processes(_rank_main, args=(world, str(workdir), device),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, workdir, world


def collect(started) -> list:
    """Wait for the ranks of :func:`start` (raising if one failed); each
    rank's list of results, in rank order."""
    ctx, workdir, world = started
    while not ctx.join():
        pass
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def spawn(world: int, workdir, plan, device: str = "cpu") -> list:
    """Run ``plan`` on ``world`` spawned gloo ranks; each rank's results."""
    return collect(start(world, workdir, plan, device))


class FakeCapture:
    """A capture function for the CPU, which has no graphs. Its 'capture'
    runs the body once for real, as a capture and the replay after it make
    one step, and each host call at once: a cut, counted. Each later
    'replay' reruns the body, its host calls at once, into the tensors of
    the first run, as a replay writes a graph's static outputs, and raises
    unless it reached the capture's cuts. ``calls`` holds each capture's
    generators, ``modes`` its capture mode and ``cuts`` its cuts."""

    def __init__(self):
        self.calls, self.modes, self.cuts = [], [], []

    def __call__(self, fn, generators, device, mode):
        from graphvqa_tpu_torch.train.graphs import _tensors
        self.calls.append(tuple(generators))
        self.modes.append(mode)

        def run():
            cuts = []

            def cut(host):
                cuts.append(host)
                host()

            return fn(cut), len(cuts)

        static, cuts = run()
        self.cuts.append(cuts)
        fresh = [True]

        def replay():
            if fresh:
                fresh.clear()
                return static
            out, again = run()
            if again != cuts:
                raise RuntimeError(f"a replay reached {again} cuts, its "
                                   f"capture {cuts}")
            for dst, src in zip(_tensors(static), _tensors(out)):
                dst.copy_(src)
            return static

        return replay


def fake_graphs(model, on):
    """``train/loop.py:_graphs`` with :class:`FakeCapture`: the steps build
    their graphs wherever they are asked to capture (here, on the CPU)."""
    from graphvqa_tpu_torch.train.graphs import StepGraphs
    return StepGraphs(FakeCapture()) if on else None


def _rank_main(rank, world, workdir, device):
    torch.set_num_threads(1)
    workdir = pathlib.Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        plan = torch.load(workdir / "plan.pt", weights_only=False)
        dev = torch.device(device)
        results = [_RUN[case["kind"]](case, dev) for case in plan]
        torch.save(results, workdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _model(case, dev):
    from graphvqa_tpu_torch.models.pipeline import PipelineModel
    model = PipelineModel(case["cfg"].model)
    model.load_state_dict(case["state_dict"])
    model = model.to(dev).eval()
    if case.get("noise") is not None:
        model.lcgn_seq.forward = functools.partial(
            model.lcgn_seq.forward, x_ctx=case["noise"].to(dev))
    return model


def _cpu(t):
    return t.detach().to("cpu", copy=True)


def _train(case, dev):
    from graphvqa_tpu_torch.core import profiling
    from graphvqa_tpu_torch.ops.cuda_lib import launch_counts
    from graphvqa_tpu_torch.parallel.edge_sharded import (
        make_dp_edge_train_step, prepare_dp_edge_batch)
    from graphvqa_tpu_torch.parallel.mesh import data_seed, make_mesh
    from graphvqa_tpu_torch.train import loop
    from graphvqa_tpu_torch.train.train_state import create_train_state
    mesh = make_mesh(case["data"], case["edge"])
    model = _model(case, dev)
    state = create_train_state(model, lr=case["lr"],
                               weight_decay=case["wd"])
    batches = case["batches"][mesh.data_rank]
    if mesh.edge > 1:
        batches = prepare_dp_edge_batch(batches, mesh)
    batches = [b.to(dev) for b in batches]
    K = case.get("k", len(batches))
    capture = case.get("capture", False)
    graphs_fn = loop._graphs
    loop._graphs = fake_graphs if capture else graphs_fn
    try:
        step = make_dp_edge_train_step(model, case["cfg"], mesh,
                                       steps_per_dispatch=K,
                                       capture=capture)
    finally:
        loop._graphs = graphs_fn
    gen = torch.Generator(device=dev).manual_seed(data_seed(0, mesh))
    ctx = torch.Generator(device=dev).manual_seed(data_seed(1, mesh))
    before = launch_counts()
    calls, reduces = [], []
    # with "trace", the program's tracing is on and its segments are read
    profiling.enable(case.get("trace", False))
    profiling.reset_segments()
    try:
        with counted_all_reduces(reduces):
            for i in range(0, len(batches), K):
                reduces.append([])
                group = batches[i:i + K]
                _, metrics = step(state, group if K > 1 else group[0], gen,
                                  ctx)
                calls.append({k: float(v) for k, v in metrics.items()})
        segments = profiling.read_segments()
    finally:
        profiling.enable(False)
    graphs = step.graphs
    return dict(
        params={n: _cpu(p) for n, p in model.named_parameters()},
        grads={n: None if p.grad is None else _cpu(p.grad)
               for n, p in model.named_parameters()},
        mu={n: _cpu(t) for n, t in state.opt_state["mu"].items()},
        nu={n: _cpu(t) for n, t in state.opt_state["nu"].items()},
        stats={n: _cpu(t) for n, t in state.batch_stats.items()},
        metrics=calls[-1], call_metrics=calls,
        all_reduces=[len(r) for r in reduces], reduce_calls=reduces,
        epg_loc=[b.graphs.edges_per_graph for b in batches],
        launches={kind: n - before[kind]
                  for kind, n in launch_counts().items()},
        device_segments=segments, **graph_record(graphs))


@contextlib.contextmanager
def counted_all_reduces(calls):
    """Each ``dist.all_reduce`` call appended to the list ``calls[-1]`` as
    (op, shape, dtype), in call order."""
    all_reduce = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        calls[-1].append((str(kwargs.get("op", dist.ReduceOp.SUM)),
                          tuple(tensor.shape), str(tensor.dtype)))
        return all_reduce(tensor, *args, **kwargs)

    dist.all_reduce = counted
    try:
        yield
    finally:
        dist.all_reduce = all_reduce


def graph_record(graphs):
    """A step's graphs (None when eager): (warm-ups, captures, replays),
    each key's segments, and the FakeCapture's cuts and capture modes."""
    if graphs is None:
        return dict(graphs=None)
    return dict(graphs=(graphs.warm_ups, graphs.captures, graphs.replays),
                segments=sorted(graphs.segments.values()),
                cuts=graphs.capture_fn.cuts, modes=graphs.capture_fn.modes)


def _eval(case, dev):
    from graphvqa_tpu_torch.parallel.edge_sharded import (
        make_edge_eval_step, prepare_edge_eval_batch)
    from graphvqa_tpu_torch.parallel.mesh import make_mesh
    from graphvqa_tpu_torch.train import loop
    mesh = make_mesh(case["data"], case["edge"])
    model = _model(case, dev)
    batch = prepare_edge_eval_batch(case["batch"], mesh).to(dev)
    capture = case.get("capture", False)
    graphs_fn = loop._graphs
    loop._graphs = fake_graphs if capture else graphs_fn
    try:
        step = make_edge_eval_step(model, case["cfg"], mesh, capture=capture)
    finally:
        loop._graphs = graphs_fn
    outs, reduces = [], []
    with counted_all_reduces(reduces):
        for _ in range(case.get("requests", 1)):
            reduces.append([])
            vec, prog, att = step(batch)
            outs.append(dict(
                vectors={k: _cpu(v) for k, v in vec.items()},
                program_tokens=_cpu(prog), node_attention=_cpu(att)))
    return dict(outs[-1], requests=outs, reduce_calls=reduces,
                **graph_record(step.graphs))


def _validate(case, dev):
    from graphvqa_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(case["data"], case["edge"])
    return run_validate(case, dev, mesh)


def run_validate(case, dev, mesh=None):
    """``validate`` over the debug fixture's ``split``, with the result and
    attention dumps under ``case['out']``: this data rank's shard of the
    batches, edge-sharded over the mesh's edge axis (one process: all)."""
    import dataclasses
    import json

    from graphvqa_tpu_torch.data import (
        GQADataset, build_scene_graph_vocab, build_text_vocab, tokenize)
    from graphvqa_tpu_torch.data.vocab import load_answer_maps
    from graphvqa_tpu_torch.parallel.edge_sharded import (
        make_edge_eval_step, prepare_edge_eval_batch)
    from graphvqa_tpu_torch.train.loop import make_eval_step, validate
    root = pathlib.Path(case["data_root"])
    programs = root / "questions" / f"{case['split']}_programs.json"
    text_vocab = build_text_vocab(json.loads(programs.read_text()), tokenize)
    ds = GQADataset(programs, root / "sceneGraphs" / "val_sceneGraphs.json",
                    text_vocab, build_scene_graph_vocab())
    cfg = case["cfg"]
    cfg = dataclasses.replace(cfg, batch=dataclasses.replace(
        cfg.batch, num_graphs=case["batch_size"]))
    model = _model(case, dev)
    d, n = (0, 1) if mesh is None else (mesh.data_rank, mesh.data)
    batches = ds.iter_batches(cfg.batch, shard_index=d, num_shards=n)
    if mesh is not None and mesh.edge > 1:
        step = make_edge_eval_step(model, cfg, mesh)
        batches = ((m, prepare_edge_eval_batch(b, mesh)) for m, b in batches)
    else:
        step = make_eval_step(model, cfg)
    out = pathlib.Path(case["out"])
    return validate(
        step, ((m, b.to(dev)) for m, b in batches), cfg,
        text_vocab=text_vocab, label2ans=load_answer_maps()[1],
        dump_path=str(out / "dump_results.json"), print_freq=1,
        dump_attentions_path=str(out / "dump_attentions.json"),
        scenes=ds.sg_data, mesh=mesh)


_RUN = {"train": _train, "eval": _eval, "validate": _validate}
