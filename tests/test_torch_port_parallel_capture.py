"""The data-parallel step replayed as CUDA graphs per batch shape
(``parallel/data_parallel.py``, ``train/graphs.py``), what the CPU can check.

Two gloo ranks are spawned once (``tests/torch_port_dist.py``); each
installs ``FakeCapture`` (its 'graph' reruns the body into the tensors of its
first run, as a replay writes a graph's static outputs) in place of the CUDA
capture, so the step runs as on the card: graph A (forward, backward, the
gradients, statistics and metrics packed into one buffer), gloo's
all-reduce on the host, graph B (the buffer unpacked, Adam). The model and
batches are ``tests/test_torch_port_parallel.py``'s (float32, dropout off).

  (a) three captured DP steps (warm-up, capture, replay) against the eager
      DP step from the same state and generators: every parameter, Adam
      moment, running statistic, gradient and each step's metrics, bitwise;
  (b) the same three steps against JAX's ``make_dp_train_step`` called
      three times, and (c) K=2 steps per call (the warm-up, then the
      capture and its replay) against JAX's two-step dispatch, both at
      ``assert_step_matches``' bounds (that file's module doc);
  (d) after a replay each rank's ``.grad`` is its own gradient before the
      reduce: the eager step's, and not the other rank's;
  (e) one ``dist.all_reduce`` per step, captured or eager;
  (f) a body's host call cuts its capture into two segments, run in order
      at every call; the edge axis builds graphs too, and a graph takes an
      edge batch (``tests/test_torch_port_edge_sharded.py`` captures the
      edge steps).
"""
import dataclasses

import jax
import pytest
import torch

from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.parallel import (
    make_dp_train_step as jax_make_dp_train_step, make_mesh as jax_make_mesh,
    multi_step_batch_sharding, shard_batch_sharding, stack_dispatch_groups,
    stack_shards)
from graphvqa_tpu_torch.parallel.data_parallel import make_dp_train_step
from graphvqa_tpu_torch.parallel.mesh import Mesh
from graphvqa_tpu_torch.train import loop
from graphvqa_tpu_torch.train.graphs import (
    StepGraphs, batch_key, host_call)
from tests import torch_port_dist
from tests.test_torch_port_parallel import (
    LR, WD, assert_step_matches, jax_config, jax_state, port_config,
    shrunk_config, to_port)
from tests.torch_port_helpers import (
    jax_variables, port_batch, port_model, random_qa_batch)


@pytest.fixture(scope="module")
def capture_run(tmp_path_factory):
    """One world-2 spawn: three captured DP steps, the same three eager, and
    one captured call of K=2 steps; JAX's DP steps meanwhile."""
    tmp = tmp_path_factory.mktemp("dp_capture")
    jcfg = shrunk_config()
    variables = jax_variables(jcfg, seed=37)
    jb = [random_qa_batch(seed=70 + i, num_graphs=3, dense=True, cfg=jcfg)
          for i in range(6)]
    pb = [port_batch(b) for b in jb]
    train = dict(kind="train", data=2, edge=1, cfg=port_config(jcfg),
                 state_dict=port_model(jcfg, variables).state_dict(), lr=LR,
                 wd=WD, k=1, batches=[pb[0::2], pb[1::2]])
    started = torch_port_dist.start(2, tmp / "run", [
        dict(train, capture=True), dict(train, capture=False),
        dict(train, capture=True, k=2, batches=[pb[0:3:2], pb[1:4:2]])])

    model, jc = JaxPipelineModel(jcfg), jax_config(jcfg)
    mesh = jax_make_mesh(data=2, edge=1, devices=jax.devices()[:2])
    step = jax_make_dp_train_step(model, jc, mesh)
    state = jax_state(variables)
    for i in range(0, 6, 2):
        state, m3 = step(state, jax.device_put(
            stack_shards(jb[i:i + 2]), shard_batch_sharding(mesh)),
            jax.random.key(3))
    stacked = stack_dispatch_groups([stack_shards(jb[:2]),
                                     stack_shards(jb[2:4])])
    two, m2 = jax_make_dp_train_step(model, jc, mesh, steps_per_dispatch=2)(
        jax_state(variables),
        jax.device_put(stacked, multi_step_batch_sharding(mesh)),
        jax.random.key(3))
    return dict(ranks=torch_port_dist.collect(started),
                three=(to_port(state, variables, "gat"), m3),
                two=(to_port(two, variables, "gat"), m2))


@pytest.mark.parametrize("rank", [0, 1])
def test_captured_dp_steps_equal_the_eager_ones_bitwise(capture_run, rank):
    cap, eager, _ = capture_run["ranks"][rank]
    assert cap["graphs"] == (1, 1, 2)        # warm-up, capture, replay
    assert eager["graphs"] is None
    assert cap["call_metrics"] == eager["call_metrics"]
    for part in ("params", "mu", "nu", "stats", "grads"):
        assert cap[part].keys() == eager[part].keys()
        for name, want in eager[part].items():
            got = cap[part][name]
            assert (got is None and want is None) or torch.equal(got, want), \
                f"{part} {name}"


@pytest.mark.parametrize("rank", [0, 1])
def test_captured_dp_steps_match_jax(capture_run, rank):
    want, metrics = capture_run["three"]
    got = capture_run["ranks"][rank][0]
    assert_step_matches(got, want, metrics)
    assert [m["short_answer_total"] for m in got["call_metrics"]] == [6] * 3


def test_captured_two_steps_per_call_match_jax(capture_run):
    want, metrics = capture_run["two"]
    for rank in capture_run["ranks"]:
        got = rank[2]
        assert got["graphs"] == (1, 1, 1)    # the warm-up, then the capture
        assert_step_matches(got, want, metrics)
        assert got["metrics"]["short_answer_total"] == 12


def test_replayed_dp_step_leaves_each_rank_its_own_gradient(capture_run):
    (r0, e0, _), (r1, e1, _) = capture_run["ranks"]
    differ = 0
    for name, g0 in r0["grads"].items():
        g1 = r1["grads"][name]
        if g0 is None:
            assert g1 is None and e0["grads"][name] is None, name
            continue
        assert torch.equal(g0, e0["grads"][name]), name
        assert torch.equal(g1, e1["grads"][name]), name
        differ += not torch.equal(g0, g1)
    assert differ > 10


def test_one_all_reduce_per_dp_step(capture_run):
    for cap, eager, two in capture_run["ranks"]:
        assert cap["all_reduces"] == eager["all_reduces"] == [1, 1, 1]
        assert two["all_reduces"] == [2]


def test_segments_run_in_order_with_the_host_call_between():
    """A body with one host call through StepGraphs with FakeCapture: the
    warm-up, the capture and a later replay each run part A, the host
    call, then part B, once each; the key holds two segments, captured in
    the relaxed mode that lets a cut fall on another thread."""
    seen = []
    capture = torch_port_dist.FakeCapture()
    graphs = StepGraphs(capture)
    batch = port_batch(random_qa_batch(seed=1, num_graphs=2, dense=True,
                                       cfg=shrunk_config()))

    def body(b):
        seen.append("a")
        a = b.questions.float().sum()
        host_call(lambda: seen.append("host"))
        seen.append("b")
        return a, torch.ones(2)

    for _ in range(3):
        a, b = graphs(body, batch)
        assert float(a) == float(batch.questions.float().sum())
        assert torch.equal(b, torch.ones(2))
    assert seen == ["a", "host", "b"] * 3
    assert (graphs.warm_ups, graphs.captures, graphs.replays) == (1, 1, 2)
    assert graphs.segments == {batch_key(batch): 2}
    assert (capture.cuts, capture.modes) == ([1], ["relaxed"])


def test_edge_axis_stays_eager_and_graphs_refuse_edge_batches(monkeypatch):
    """The edge axis now builds graphs as the DP step does, and StepGraphs
    takes an edge-sharded batch: warm-up, capture, replay (the name is the
    refusal's that this replaced)."""
    monkeypatch.setattr(loop, "_graphs", torch_port_dist.fake_graphs)
    jcfg = shrunk_config()
    cfg = port_config(jcfg)
    model = port_model(jcfg, jax_variables(jcfg, seed=37))
    assert make_dp_train_step(model, cfg, Mesh(data=1, edge=1, rank=0)
                              ).graphs is not None
    assert make_dp_train_step(model, cfg, Mesh(data=1, edge=1, rank=0),
                              capture=False).graphs is None
    assert make_dp_train_step(model, cfg, Mesh(data=1, edge=2, rank=0)
                              ).graphs is not None
    assert make_dp_train_step(model, cfg, Mesh(data=1, edge=2, rank=0),
                              capture=False).graphs is None
    batch = port_batch(random_qa_batch(seed=2, num_graphs=2, dense=True,
                                       cfg=jcfg))
    sharded = dataclasses.replace(batch, graphs=dataclasses.replace(
        batch.graphs, edge_group=object()))
    graphs = StepGraphs(torch_port_dist.FakeCapture())
    for _ in range(3):
        assert graphs(lambda b: b.questions + 1, sharded).equal(
            batch.questions + 1)
    assert (graphs.warm_ups, graphs.captures, graphs.replays) == (1, 1, 2)
