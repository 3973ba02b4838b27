"""The port's tracing (``graphvqa_tpu_torch/core/profiling.py``) on the CPU:

  (a) with tracing off, a profiled train step and eval step (eager, and
      through the step graphs) leave no ``gvqa.`` event and make no stamp;
  (b) with tracing on, the spans at the layer boundaries appear in the
      profile, nested as the steps and loops open them;
  (c) the device segments on the host clock: each segment a step reaches
      accumulates a positive time, the others none, and the step count is
      the steps run, eager and through the step graphs;
  (d) turning tracing on or off drops the step graphs;
  (e) the CLI's ``--profile-dir`` turns tracing on and prints the segments.

The card's own check (no stamp kernel in a graph captured with tracing
off; the segments against the profiler's device time) is in
``tests/test_torch_port_cuda.py``; the data-parallel step's ``allreduce``
segment in ``tests/test_torch_port_parallel.py``.
"""
import contextlib
import io
import pathlib
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import graphvqa_tpu_torch.train.loop as loop
from graphvqa_tpu_torch.core import profiling
from graphvqa_tpu_torch.data.prefetch import prefetch
from graphvqa_tpu_torch.models.pipeline import build_model
from graphvqa_tpu_torch.train.graphs import StepGraphs, host_call
from graphvqa_tpu_torch.train.loop import (
    make_eval_step, make_train_step, train_one_epoch, validate)
from graphvqa_tpu_torch.train.train_state import create_train_state
from tests.torch_port_dist import FakeCapture
from tests.torch_port_fixtures import tiny_train_case

DEBUG = (pathlib.Path(__file__).resolve().parent.parent / "graphvqa_tpu_torch"
         / "assets" / "debug")
TRAIN_SEGMENTS = {"encoders", "program_decoder", "engine", "classifier",
                  "loss_backward", "optimizer"}
EVAL_SEGMENTS = {"encoders", "program_decoder", "engine", "classifier",
                 "full_answer_decoder"}


@pytest.fixture
def tracing():
    """Tracing on for the test, off again after it, the segments zeroed."""
    profiling.reset_segments()
    profiling.enable(True)
    yield
    profiling.enable(False)
    profiling.reset_segments()


@pytest.fixture
def stamps(monkeypatch):
    """Every stamp the program makes, as (segment index or -1, device)."""
    seen = []
    mark = profiling._mark

    def counted(k, device):
        seen.append((k, device))
        mark(k, device)

    monkeypatch.setattr(profiling, "_mark", counted)
    return seen


def _case(graphs: bool, monkeypatch):
    """The tiny float32 model and batch; with ``graphs`` the steps build
    their graphs with FakeCapture here on the CPU."""
    cfg, batch = tiny_train_case()
    if graphs:
        monkeypatch.setattr(loop, "_graphs", lambda model, on: (
            StepGraphs(FakeCapture()) if on else None))
    model = build_model(cfg.model, device="cpu", seed=3)
    return cfg, batch, model


def _run(kind, cfg, batch, model, n):
    if kind == "train":
        step = make_train_step(model, cfg)
        state = create_train_state(model, lr=1e-3)
        gen = torch.Generator().manual_seed(0)
        for _ in range(n):
            step(state, batch, gen)
    else:
        step = make_eval_step(model, cfg)
        for _ in range(n):
            step(batch)
    return step


def _events(prof):
    return [ev for ev in prof.events() if ev.name.startswith("gvqa.")]


def _ancestors(ev):
    out = []
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
        out.append(ev.name)
    return out


# --- (a) off: nothing -----------------------------------------------------------

@pytest.mark.parametrize("graphs", [False, True])
@pytest.mark.parametrize("kind", ["train", "eval"])
def test_tracing_off_leaves_no_event_and_no_stamp(kind, graphs, stamps,
                                                  monkeypatch):
    assert not profiling.enabled()
    cfg, batch, model = _case(graphs, monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step = _run(kind, cfg, batch.to("cpu"), model, 3)
    assert (step.graphs is not None) == graphs
    assert _events(prof) == [] and stamps == []
    assert any(ev.name.startswith("aten::") for ev in prof.events())


# --- (b) on: the spans, nested ----------------------------------------------------

def test_tracing_on_spans_nest_as_listed(tracing, monkeypatch):
    cfg, batch, model = _case(True, monkeypatch)
    step = make_train_step(model, cfg)
    eval_step = make_eval_step(model, cfg)
    state = create_train_state(model, lr=1e-3)
    graphs = StepGraphs(FakeCapture())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        feed = prefetch([(None, batch)] * 4, depth=2)
        train_one_epoch(step, state, feed, torch.Generator().manual_seed(0),
                        0, print_freq=2)
        # moved to the device on this thread: the profiler records the
        # ranges of the thread that started it
        validate(eval_step, (({"real_count": 3}, batch.to("cpu"))
                             for _ in range(3)), cfg)
        for _ in range(2):
            graphs(lambda b: host_call(lambda: None), batch)
    events = _events(prof)
    names = {ev.name for ev in events}
    assert names == {
        "gvqa.step", "gvqa.step.warm_up", "gvqa.step.capture",
        "gvqa.step.copy_in", "gvqa.step.replay", "gvqa.step.host_call",
        "gvqa.loop.next_batch", "gvqa.prefetch.get", "gvqa.batch.to_device",
        "gvqa.loop.meters", "gvqa.eval.readback"}
    for ev in events:
        up = _ancestors(ev)
        if ev.name == "gvqa.step.host_call":
            # here a warm-up's; a replay's lies under gvqa.step.replay
            assert up[:2] == ["gvqa.step.warm_up", "gvqa.step"]
        elif ev.name.startswith("gvqa.step."):
            assert up[0] == "gvqa.step", (ev.name, up)
        if ev.name == "gvqa.prefetch.get":
            assert up[0] == "gvqa.loop.next_batch"
        if ev.name in ("gvqa.step", "gvqa.loop.next_batch",
                       "gvqa.loop.meters", "gvqa.eval.readback"):
            assert not any(n.startswith("gvqa.") for n in up), (ev.name, up)
    count = {n: sum(ev.name == n for ev in events) for n in names}
    # 4 train steps, 3 eval requests and 2 calls of the host-call body: each
    # graph set warms up, captures, then replays with a copy-in
    assert count["gvqa.step"] == 9
    assert count["gvqa.step.warm_up"] == count["gvqa.step.capture"] == 3
    assert count["gvqa.step.replay"] == 6
    assert count["gvqa.step.copy_in"] == 3
    # 4 batches and the end of each feed
    assert count["gvqa.loop.next_batch"] == 5 + 4
    assert count["gvqa.prefetch.get"] == 5
    assert count["gvqa.batch.to_device"] == 3
    assert count["gvqa.eval.readback"] == 3
    # prints at steps 0 and 2, and the epoch's end
    assert count["gvqa.loop.meters"] == 3


# --- (c) the segments ---------------------------------------------------------------

@pytest.mark.parametrize("graphs", [False, True])
@pytest.mark.parametrize("kind,n,want", [
    ("train", 3, TRAIN_SEGMENTS), ("eval", 4, EVAL_SEGMENTS)])
def test_segments_accumulate_per_step(kind, n, want, graphs, tracing,
                                      stamps, monkeypatch):
    cfg, batch, model = _case(graphs, monkeypatch)
    _run(kind, cfg, batch, model, n)
    steps, seconds = profiling.read_segments()
    assert steps == n
    assert set(seconds) == set(profiling.SEGMENTS)
    assert {k for k, s in seconds.items() if s > 0} == want
    assert all(s >= 0 for s in seconds.values())
    # each step: one begin, then one stamp per segment it reached
    assert len(stamps) == n * (1 + len(want))
    assert all(dev.type == "cpu" for _, dev in stamps)
    profiling.reset_segments()
    assert profiling.read_segments() == (
        0, {k: 0.0 for k in profiling.SEGMENTS})


def test_segment_time_is_the_time_between_stamps(tracing, monkeypatch):
    """On the host clock a segment is the time from the previous stamp;
    the time before a step's begin goes to no segment."""
    clock = iter([100, 250, 1000, 1040, 5000, 5500])
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(clock)))
    cpu = torch.device("cpu")
    profiling.begin(cpu)
    profiling.stamp("encoders", cpu)
    profiling.begin(cpu)
    profiling.stamp("engine", cpu)
    profiling.stamp("engine", cpu)
    profiling.stamp("optimizer", cpu)
    steps, seconds = profiling.read_segments()
    assert steps == 2
    assert seconds["encoders"] == 150 / 1e9
    assert seconds["engine"] == (40 + 3960) / 1e9
    assert seconds["optimizer"] == 500 / 1e9


# --- (d) the switch drops the graphs ------------------------------------------------

def test_toggling_tracing_drops_the_step_graphs():
    capture = FakeCapture()
    graphs = StepGraphs(capture)
    _, batch = tiny_train_case()

    def body(b):
        return b.questions.float().sum()

    for _ in range(3):
        graphs(body, batch)
    assert (graphs.warm_ups, graphs.captures, graphs.replays) == (1, 1, 2)
    try:
        profiling.enable(True)
        graphs(body, batch)          # dropped: an eager warm-up again
        assert (graphs.warm_ups, len(graphs.graphs)) == (2, 1)
        graphs(body, batch)          # captured with tracing on
        graphs(body, batch)
        assert (graphs.warm_ups, graphs.captures) == (2, 2)
    finally:
        profiling.enable(False)
    graphs(body, batch)              # off again: dropped once more
    assert (graphs.warm_ups, graphs.captures) == (3, 2)
    assert len(capture.calls) == 2


# --- (e) the CLI ----------------------------------------------------------------------

def test_cli_profile_dir_turns_tracing_on_and_prints_segments(tmp_path):
    from graphvqa_tpu_torch.cli.train_cli import get_args_parser, main
    root = tmp_path / "data"
    (root / "questions").mkdir(parents=True)
    (root / "sceneGraphs").mkdir()
    (root / "questions" / "debug_programs.json").write_bytes(
        (DEBUG / "debug_programs.json").read_bytes())
    (root / "sceneGraphs" / "val_sceneGraphs.json").write_bytes(
        (DEBUG / "debug_sceneGraphs.json").read_bytes())
    args = get_args_parser().parse_args([
        "--tiny", "--device", "cpu", "--data-root", str(root), "--split",
        "debug", "--val-split", "debug", "--batch-size", "2", "--epochs",
        "1", "--validate-every", "1", "--print-freq", "1",
        "--output_dir", str(tmp_path / "out"),
        "--profile-dir", str(tmp_path / "trace")])
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            main(args)
    finally:
        profiling.enable(False)
        profiling.reset_segments()
    text = out.getvalue()
    lines = [ln for ln in text.splitlines()
             if ln.startswith("device segments (train epoch 0")]
    assert len(lines) == 1, text
    assert "ms per step over 3 steps" in lines[0]
    for name in TRAIN_SEGMENTS:
        assert f"{name} " in lines[0], lines[0]
    assert any(ln.startswith("device segments (validate epoch 0")
               for ln in text.splitlines())
    # without the flag the switch is off again and nothing is printed
    profiling.enable(True)
    out = io.StringIO()
    args.profile_dir, args.output_dir = "", str(tmp_path / "out2")
    with contextlib.redirect_stdout(out):
        main(args)
    assert not profiling.enabled()
    assert "device segments" not in out.getvalue()
