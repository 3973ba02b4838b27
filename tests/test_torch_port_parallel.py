"""The port's data-parallel paths against the JAX package, on the CPU.

JAX runs on its conftest's emulated host devices; the port on spawned gloo
ranks (``tests/torch_port_dist.py``, which imports no JAX), started before
the JAX side compiles so that both run at once. Weights cross over with
``models/convert.py``; batches are made with numpy from a seed; dropout is
off and everything is float32 (``tests/test_parallel.py``'s shrunken tiny
model: 1 transformer layer, 2 rounds). Bounds, the port's train-step bounds
against JAX (``tests/test_torch_port_train.py``), none looser than JAX's
own rtol 5e-4 / atol 5e-5:
  * loss parts and counts: rtol 1e-5 (counts exact);
  * Adam's moments, i.e. the reduced gradients (mu = 0.1 g, nu = 1e-3 g^2
    after one step; nu compared as its square root): within 2e-5 of the
    tensor's largest value, rtol 2e-5, plus the gradient's 5e-8 on their
    scale, for gradients that are 0 in exact arithmetic and come out as
    round-off;
  * parameters: rtol 5e-4 / atol 5e-5 everywhere (lr 2e-5, so that even an
    ill-conditioned first Adam step, |g| near eps, moves a parameter by at
    most 2 lr = 4e-5) and atol 1e-6 where JAX's |mu| > 1e-7 (|g| > 1e-6);
  * BatchNorm running statistics: rtol/atol 1e-5.
Validate across ranks holds the gathered dumps and synced meters to one
process's run over the same questions (tests/torch_port_dist.py
run_validate): predictions and programs equal, attention within 1e-6 and
the 2-decimal prediction score within 0.01 (the ranks' batches pad to other
rungs, which reorders float32 sums), meters rtol 1e-12.
"""
import dataclasses
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvqa_tpu_torch.config as pcfg
from graphvqa_tpu.config import BatchConfig, Config, TrainConfig
from graphvqa_tpu.core.packing import repack_dense as jax_repack_dense
from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.parallel import (
    make_dp_train_step, make_mesh as jax_make_mesh,
    multi_step_batch_sharding, shard_batch_sharding, stack_dispatch_groups,
    stack_shards)
from graphvqa_tpu.train.train_state import (
    create_train_state as jax_create_train_state)
from graphvqa_tpu_torch.cli.train_cli import (
    build_config, get_args_parser, main as cli_main)
from graphvqa_tpu_torch.core.packing import repack_dense
from graphvqa_tpu_torch.data import build_scene_graph_vocab, build_text_vocab
from graphvqa_tpu_torch.data import tokenize
from graphvqa_tpu_torch.models.convert import from_jax_variables
from graphvqa_tpu_torch.models.pipeline import build_model
from graphvqa_tpu_torch.parallel import collectives
from graphvqa_tpu_torch.parallel.mesh import data_seed, make_mesh
from tests import torch_port_dist
from tests.torch_port_helpers import (
    jax_variables, port_batch, port_graph, port_model, port_model_config,
    random_qa_batch, tiny_model_config)

LR, WD = 2e-5, 1e-2
REPO = pathlib.Path(__file__).resolve().parent.parent
ASSETS = REPO / "graphvqa_tpu_torch" / "assets" / "debug"


def shrunk_config(kind="gat"):
    """tests/test_parallel.py's _shrink, dropout off."""
    m = tiny_model_config(kind)
    return dataclasses.replace(
        m, transformer=dataclasses.replace(m.transformer, dropout=0.0,
                                           num_layers=1),
        engine=dataclasses.replace(m.engine, dropout=0.0, num_rounds=2),
        max_execution_steps=2, classifier_dropout=0.0)


def port_config(jcfg):
    return pcfg.Config(model=port_model_config(jcfg),
                       train=pcfg.TrainConfig(use_program_loss=True))


def jax_config(jcfg):
    return Config(model=jcfg, batch=BatchConfig(),
                  train=TrainConfig(use_program_loss=True))


def jax_state(variables):
    return jax_create_train_state(jax.tree.map(jnp.asarray, variables),
                                  lr=LR, weight_decay=WD)


def to_port(state, variables, kind):
    """A JAX train state's parameters, Adam moments and statistics by the
    port's names."""
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))

    def names(params):
        return from_jax_variables(
            {"params": jax.device_get(params),
             "batch_stats": variables["batch_stats"]}, kind)

    stats = from_jax_variables(
        {"params": variables["params"],
         "batch_stats": jax.device_get(state.batch_stats)}, kind)
    return dict(params=names(state.params), mu=names(adam.mu),
                nu=names(adam.nu),
                stats={k: v for k, v in stats.items()
                       if k.endswith(("running_mean", "running_var"))})


def assert_step_matches(got, want, jax_metrics):
    """One rank's train-step results against JAX's (module doc bounds)."""
    keys = set(got["metrics"]) - {"lr"}
    assert keys == set(jax_metrics)
    for k in keys:
        np.testing.assert_allclose(got["metrics"][k], float(jax_metrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert set(got["params"]) == set(got["mu"]) <= set(want["params"])
    # both moments on the gradient's scale: mu = 0.1 g, sqrt(nu) = 0.0316 |g|
    for moment, scale in (("mu", 0.1), ("nu", 0.001 ** 0.5)):
        for name, g in got[moment].items():
            g, w = g.numpy(), want[moment][name].numpy()
            if moment == "nu":
                g, w = np.sqrt(g), np.sqrt(w)
            np.testing.assert_allclose(
                g, w, rtol=2e-5, atol=2e-5 * np.abs(w).max() + scale * 5e-8,
                err_msg=f"{moment} {name}")
    for name, g in got["params"].items():
        g, w = g.numpy(), want["params"][name].numpy()
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-5, err_msg=name)
        cond = np.abs(want["mu"][name].numpy()) > 1e-7
        np.testing.assert_allclose(g[cond], w[cond], rtol=0, atol=1e-6,
                                   err_msg=name)
    assert set(got["stats"]) >= set(want["stats"])
    for name, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][name].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def debug_root(tmp_path):
    root = tmp_path / "data"
    (root / "questions").mkdir(parents=True)
    (root / "sceneGraphs").mkdir()
    shutil.copy(ASSETS / "debug_programs.json", root / "questions")
    shutil.copy(ASSETS / "debug_sceneGraphs.json",
                root / "sceneGraphs" / "val_sceneGraphs.json")
    return root


def validate_case(tmp_path, data, edge, out):
    """A 'validate' case on the debug fixture: the CLI's --tiny gat model
    (float32, 2 rounds), seeded weights, batches of 2."""
    root = debug_root(tmp_path)
    args = get_args_parser().parse_args([
        "--tiny", "--data-root", str(root), "--dtype", "float32",
        "--rounds", "2", "--nodes-per-graph", "16"])
    tv = build_text_vocab(json.loads(
        (root / "questions" / "debug_programs.json").read_text()), tokenize)
    cfg = build_config(args, len(tv), len(build_scene_graph_vocab()))
    model = build_model(cfg.model, device="cpu", seed=3)
    return dict(kind="validate", data=data, edge=edge, cfg=cfg,
                state_dict=model.state_dict(), data_root=str(root),
                split="debug", batch_size=2, out=str(out))


def assert_validate_matches(case, got_res, tmp_path):
    """Rank 0's gathered dumps and every rank's synced meters against one
    process's validate over the same questions."""
    single = dict(case, out=str(tmp_path / "single"))
    want_res = torch_port_dist.run_validate(single, torch.device("cpu"))
    for res in got_res:
        assert res.keys() == want_res.keys()
        for k in res:
            np.testing.assert_allclose(res[k], want_res[k], rtol=1e-12,
                                       err_msg=k)
    got = json.loads((pathlib.Path(case["out"])
                      / "dump_results.json").read_text())
    want = json.loads((tmp_path / "single" / "dump_results.json").read_text())
    assert sorted(got) == sorted(want) and len(got) == 7
    for qid, w in want.items():
        g = dict(got[qid])
        assert abs(float(g.pop("prediction_score"))
                   - float(w["prediction_score"])) <= 0.01 + 1e-9
        assert g == {k: v for k, v in w.items() if k != "prediction_score"}
    got_att = {r["questionId"]: r["attention"] for r in json.loads(
        (pathlib.Path(case["out"]) / "dump_attentions.json").read_text())}
    want_att = json.loads(
        (tmp_path / "single" / "dump_attentions.json").read_text())
    assert len(got_att) == len(want_att)
    for row in want_att:
        np.testing.assert_allclose(got_att[row["questionId"]],
                                   row["attention"], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """One world-2 spawn: the DP step on two distinct shards, the DP step
    with K=2 steps per call, and validate; JAX's DP steps meanwhile."""
    tmp = tmp_path_factory.mktemp("dp")
    jcfg = shrunk_config()
    variables = jax_variables(jcfg, seed=31)
    jb = [random_qa_batch(seed=40 + i, num_graphs=3, dense=True, cfg=jcfg)
          for i in range(4)]
    pb = [port_batch(b) for b in jb]
    cfg = port_config(jcfg)
    sd = port_model(jcfg, variables).state_dict()
    train = dict(kind="train", data=2, edge=1, cfg=cfg, state_dict=sd,
                 lr=LR, wd=WD)
    vcase = validate_case(tmp, 2, 1, tmp / "ranks")
    # the K=2 case runs with the program's tracing on: it must step as the
    # others do, and its segments are read
    started = torch_port_dist.start(2, tmp / "run", [
        dict(train, batches=[[pb[0]], [pb[1]]]),
        dict(train, batches=[[pb[0], pb[2]], [pb[1], pb[3]]], trace=True),
        vcase])

    model, jc = JaxPipelineModel(jcfg), jax_config(jcfg)
    mesh = jax_make_mesh(data=2, edge=1, devices=jax.devices()[:2])
    one, m1 = make_dp_train_step(model, jc, mesh)(
        jax_state(variables),
        jax.device_put(stack_shards(jb[:2]), shard_batch_sharding(mesh)),
        jax.random.key(3))
    stacked = stack_dispatch_groups([stack_shards(jb[:2]),
                                     stack_shards(jb[2:])])
    two, m2 = make_dp_train_step(model, jc, mesh, steps_per_dispatch=2)(
        jax_state(variables),
        jax.device_put(stacked, multi_step_batch_sharding(mesh)),
        jax.random.key(3))
    ranks = torch_port_dist.collect(started)
    return dict(ranks=ranks, vcase=vcase, tmp=tmp,
                one=(to_port(one, variables, "gat"), m1),
                two=(to_port(two, variables, "gat"), m2))


@pytest.mark.parametrize("rank", [0, 1])
def test_dp_step_matches_jax_on_distinct_shards(dp_run, rank):
    want, metrics = dp_run["one"]
    got = dp_run["ranks"][rank][0]
    assert_step_matches(got, want, metrics)
    assert got["metrics"]["short_answer_total"] == 6


def test_dp_step_leaves_each_rank_its_own_gradient(dp_run):
    """.grad is the rank's own (pre-reduce) gradient: the two shards' differ
    and their mean is the gradient Adam took (mu / 0.1)."""
    r0, r1 = (dp_run["ranks"][r][0] for r in (0, 1))
    want = dp_run["one"][0]["mu"]
    differ = 0
    for name, g0 in r0["grads"].items():
        g1, w = r1["grads"][name], want[name]
        if g0 is None or g1 is None:
            assert g0 is None and g1 is None and not w.abs().any(), name
            continue
        differ += not torch.equal(g0, g1)
        w = w.numpy() / np.float32(0.1)
        np.testing.assert_allclose(((g0 + g1) / 2).numpy(), w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max() + 5e-8,
                                   err_msg=name)
    assert differ > 10


def test_dp_step_ranks_end_identical(dp_run):
    for case in range(2):
        r0, r1 = (dp_run["ranks"][r][case] for r in (0, 1))
        for part in ("params", "mu", "nu", "stats"):
            for name in r0[part]:
                assert torch.equal(r0[part][name], r1[part][name]), name
        assert r0["metrics"] == r1["metrics"]


def test_dp_two_steps_per_call_match_jax(dp_run):
    want, metrics = dp_run["two"]
    got = dp_run["ranks"][0][1]
    assert_step_matches(got, want, metrics)
    assert got["metrics"]["short_answer_total"] == 12


def test_dp_step_reports_its_allreduce_segment(dp_run):
    """With tracing on, each rank's two DP steps begin two steps of device
    segments (host clock here), the all-reduce among them; with it off,
    none."""
    for rank in dp_run["ranks"]:
        assert rank[0]["device_segments"] == (
            0, {k: 0.0 for k in rank[0]["device_segments"][1]})
        steps, seconds = rank[1]["device_segments"]
        assert steps == 2
        assert {k for k, s in seconds.items() if s > 0} == {
            "encoders", "program_decoder", "engine", "classifier",
            "loss_backward", "optimizer", "allreduce"}


def test_validate_across_two_ranks_matches_one_process(dp_run, tmp_path):
    assert_validate_matches(dp_run["vcase"],
                            [r[2] for r in dp_run["ranks"]], tmp_path)


def test_repack_dense_matches_jax():
    jb = random_qa_batch(seed=5, num_graphs=3, dense=True,
                         nodes_per_graph=8, edges_per_graph=16)
    want = jax_repack_dense(jb.graphs, 16, 32)
    got = repack_dense(port_graph(jb.graphs), 16, 32)
    assert (got.nodes_per_graph, got.edges_per_graph) == (16, 32)
    for f in ("node_tokens", "node_graph", "node_mask", "exec_bitmap",
              "edge_src", "edge_dst", "edge_tokens", "edge_mask",
              "edge_sym_sign"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    g = port_graph(jb.graphs)
    assert repack_dense(g, 8, 16) is g
    with pytest.raises(ValueError):
        repack_dense(g, 4, 16)


def test_one_process_mesh_and_collectives_are_the_identity():
    mesh = make_mesh()
    assert (mesh.data, mesh.edge, mesh.rank, mesh.size) == (1, 1, 0, 1)
    assert mesh.is_main and mesh.world_group is None
    assert mesh.data_group is None and mesh.edge_group is None
    assert data_seed(7, mesh) == 7
    t = {"a": torch.tensor(2.0)}
    assert collectives.psum_scalars(t, None) == t
    assert collectives.all_gather_host({"x": 1}) == [{"x": 1}]
    x = torch.randn(3, requires_grad=True)
    assert collectives.assemble_rows(x, None) is x
    assert collectives.pmax(x, None) is x
    with pytest.raises(ValueError, match="mesh 2x1"):
        make_mesh(2, 1)


def _cli(root, out, extra):
    return ["--model", "gat", "--tiny", "--device", "cpu", "--data-root",
            str(root), "--split", "debug", "--val-split", "debug",
            "--batch-size", "2", "--nodes-per-graph", "32",
            "--edges-per-graph", "256", "--output_dir", str(out),
            "--rounds", "2"] + extra


def test_cli_data_times_edge_parallel_under_torchrun(tmp_path):
    """--data-parallel 2 --edge-parallel 2 as four torchrun ranks on the
    CPU (gloo): two epochs, a fast validation after the second, and the
    checkpoint, which rank 0 alone writes and reports."""
    root, out = debug_root(tmp_path), tmp_path / "out"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "4", "-m", "graphvqa_tpu_torch.cli.train_cli"
           ] + _cli(root, out, [
               "--print-freq", "1000", "--epochs", "2", "--lr", "1e-3",
               "--data-parallel", "2", "--edge-parallel", "2",
               "--validate-every", "2", "--fast-validate", "1"])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    stdout = run.stdout
    assert stdout.count("checkpoint saved:") == 2
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == [
        "ckpt_0.pt", "ckpt_1.pt"]
    losses = [float(v) for v in re.findall(r"Loss (\S+) \(", stdout)]
    assert losses and np.isfinite(losses).all()
    res = re.findall(r"^debug (\{.*\})$", stdout, re.M)
    assert len(res) == 1 and "short_answer_acc" in res[0]
    assert (out / "log-gat.txt").stat().st_size > 0


def test_cli_edge_parallel_checks_layout_and_divisibility():
    from graphvqa_tpu_torch.cli.train_cli import _check_mesh
    parse = get_args_parser().parse_args
    with pytest.raises(SystemExit, match="divisible by --edge-parallel 4"):
        _check_mesh(parse(["--data-root", "x", "--edge-parallel", "4",
                           "--nodes-per-graph", "30"]), 4)
    with pytest.raises(SystemExit, match="requires --layout dense"):
        _check_mesh(parse(["--data-root", "x", "--edge-parallel", "2",
                           "--layout", "flat"]), 2)
    _check_mesh(parse(["--data-root", "x", "--data-parallel", "2",
                       "--edge-parallel", "2"]), 4)


def test_init_distributed_without_rank_variables_stays_one_process(
        monkeypatch):
    from graphvqa_tpu_torch.parallel.mesh import maybe_init_distributed
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert maybe_init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    """NCCL gives each rank a card of its own: two local ranks on a host
    with one card raise (and name --dist-backend gloo) before any process
    group forms, rather than oversubscribing the card."""
    from graphvqa_tpu_torch.parallel.mesh import maybe_init_distributed
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        maybe_init_distributed("cuda")
    assert not torch.distributed.is_initialized()
