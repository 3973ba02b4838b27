"""Spawned ranks of the port's multi-rank tests, importing no JAX (spawned
children re-import this module, and the card's machine has no JAX).

``spawn(world, workdir, plan, device)`` starts ``world`` processes that
join one gloo process group on a ``file://`` store under ``workdir`` (no
port to collide under xdist) and run every case of ``plan`` in order, each
on its own (data, edge) mesh of the world; every rank saves its results to
``workdir/rank<r>.pt``. A case is a dict with ``kind`` ('train', 'eval' or
'validate'), ``data`` and ``edge`` and the kind's inputs, all on the CPU:

  * train: ``cfg`` (the port's Config), ``state_dict``, ``lr``, ``wd``,
    ``batches`` (per data rank, a list of K batches), optional LCGN
    ``noise``; the result: parameters, Adam moments, running statistics,
    the step's metrics, this rank's own gradients and its shard's
    edges_per_graph;
  * eval: ``cfg``, ``state_dict``, ``batch``; the eval step's outputs;
  * validate: ``cfg``, ``state_dict``, ``data_root``, ``split``,
    ``batch_size`` and ``out`` (a directory for rank 0's dumps); the
    result dict of ``validate``.
"""
from __future__ import annotations

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
    from graphvqa_tpu_torch.ops.gat_round import gat_round, gat_round_backward
    from graphvqa_tpu_torch.parallel.edge_sharded import (
        make_dp_edge_train_step, prepare_dp_edge_batch)
    from graphvqa_tpu_torch.parallel.mesh import data_seed, make_mesh
    from graphvqa_tpu_torch.train.train_state import create_train_state
    mesh = make_mesh(case["data"], case["edge"])
    model = _model(case, dev)
    state = create_train_state(model, lr=case["lr"],
                               weight_decay=case["wd"])
    batches = case["batches"][mesh.data_rank]
    if mesh.edge > 1:
        batches = prepare_dp_edge_batch(batches, mesh)
    batches = [b.to(dev) for b in batches]
    K = len(batches)
    step = make_dp_edge_train_step(model, case["cfg"], mesh,
                                   steps_per_dispatch=K)
    gen = torch.Generator(device=dev).manual_seed(data_seed(0, mesh))
    ctx = torch.Generator(device=dev).manual_seed(data_seed(1, mesh))
    before = gat_round.launches, gat_round_backward.launches
    _, metrics = step(state, batches if K > 1 else batches[0], gen, ctx)
    return dict(
        params={n: _cpu(p) for n, p in model.named_parameters()},
        grads={n: None if p.grad is None else _cpu(p.grad)
               for n, p in model.named_parameters()},
        mu={n: _cpu(t) for n, t in state.opt_state["mu"].items()},
        nu={n: _cpu(t) for n, t in state.opt_state["nu"].items()},
        stats={n: _cpu(t) for n, t in state.batch_stats.items()},
        metrics={k: float(v) for k, v in metrics.items()},
        epg_loc=[b.graphs.edges_per_graph for b in batches],
        launches=(gat_round.launches - before[0],
                  gat_round_backward.launches - before[1]))


def _eval(case, dev):
    from graphvqa_tpu_torch.parallel.edge_sharded import (
        make_edge_eval_step, prepare_edge_eval_batch)
    from graphvqa_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(case["data"], case["edge"])
    model = _model(case, dev)
    batch = prepare_edge_eval_batch(case["batch"], mesh).to(dev)
    vec, prog, att = make_edge_eval_step(model, case["cfg"], mesh)(batch)
    return dict(vectors={k: _cpu(v) for k, v in vec.items()},
                program_tokens=_cpu(prog), node_attention=_cpu(att))


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
