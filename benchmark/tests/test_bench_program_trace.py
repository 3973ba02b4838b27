"""The program's spans and segments as the benchmark reads them
(``harness/program_trace.py``, ``metrics/collate_busy_pct.*``), on
synthetic profiler events and windows, and once through a tiny traced run
on the CPU."""
import json
import subprocess
import sys
import types

import pytest
from torch.autograd import DeviceType

from harness import cell
from harness.common import Window
from harness.main import read_metric
from harness.program_trace import (
    idle_by_span, segments_ms, step_call_idle_s)
from harness.trace import NEXT_BATCH, summarize

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
MAIN, PREFETCH = 1, 7


def ev(name, start, end, dev=CPU, thread=MAIN, mirror=False):
    return types.SimpleNamespace(
        name=name, device_type=dev, thread=thread, is_user_annotation=mirror,
        time_range=types.SimpleNamespace(start=start, end=end))


def base_events():
    """Two steps' kernels around a wait for the next batch, the prefetch
    thread's copy inside the wait."""
    return [
        ev("aten::copy_", 0, 3), ev("cudaGraphLaunch", 5, 8),
        ev("kernel", 10, 300, CUDA),
        ev(NEXT_BATCH, 100, 400), ev("cudaMemcpyAsync", 300, 310,
                                     thread=PREFETCH),
        ev("Memcpy HtoD", 330, 335, CUDA),
        ev("cudaGraphLaunch", 405, 410), ev("kernel", 420, 900, CUDA),
        ev("cudaStreamSynchronize", 900, 1000)]


def with_program_spans(events):
    """The same run with the program's spans and their device mirrors."""
    return events + [
        ev("gvqa.step", 0, 100), ev("gvqa.step.replay", 4, 9),
        ev("gvqa.loop.next_batch", 95, 402),
        ev("gvqa.prefetch.get", 110, 398),
        ev("gvqa.batch.to_device", 290, 340, thread=PREFETCH),
        ev("gvqa.step", 402, 415), ev("gvqa.step.replay", 404, 412),
        ev("gvqa.loop.meters", 895, 1000),
        ev("gvqa.step.replay", 10, 300, CUDA, mirror=True),
        ev("gvqa.step.replay", 420, 900, CUDA, mirror=True)]


def test_program_spans_leave_the_summary_as_it_was():
    """Every field of the benchmark's reduction reads as without the
    program's spans and mirrors; only the idle gaps' names may now be the
    program's spans (the innermost host event open at each gap)."""
    before = summarize(types.SimpleNamespace(events=base_events), 1e-3)
    after = summarize(types.SimpleNamespace(
        events=lambda: with_program_spans(base_events())), 1e-3)
    for key in before:
        if key != "idle_gaps":
            assert after[key] == before[key], key
    assert sorted(g[1] for g in after["idle_gaps"]) == sorted(
        g[1] for g in before["idle_gaps"])
    assert before["busy_s"] == pytest.approx((290 + 5 + 480) / 1e6)


def test_a_gap_goes_to_the_issuing_threads_span():
    """The gaps from 300 and from 335 begin while the prefetch thread copies
    a batch (its span and its cudaMemcpyAsync are open): they go to the
    span the step's thread waits in, each whole, by where it began. The
    benchmark's own reduction names the first after the other thread's
    copy."""
    events = with_program_spans(base_events())
    by = idle_by_span(events)
    assert by == pytest.approx({
        "gvqa.step": 10e-6,                      # 0-10
        "gvqa.prefetch.get": (30 + 85) * 1e-6,   # 300-330, 335-420
        "gvqa.loop.meters": 100e-6})             # 900-1000
    assert step_call_idle_s(by) == pytest.approx(10e-6)
    named = summarize(types.SimpleNamespace(events=lambda: events), 1e-3)
    assert ["cudaMemcpyAsync", 30e-6] in [
        [n, pytest.approx(v)] for n, v in named["idle_gaps"]]
    # without the program's spans only the benchmark's is there
    by = idle_by_span(base_events())
    assert by == pytest.approx({"outside": (10 + 100) * 1e-6,
                                NEXT_BATCH: (30 + 85) * 1e-6})


def test_segments_per_step_and_their_cover():
    got = segments_ms((4, {"encoders": 0.004, "engine": 0.012,
                           "allreduce": 0.0}), busy_s=0.02)
    assert got["steps"] == 4
    assert got["ms"] == pytest.approx({"encoders": 1.0, "engine": 3.0})
    assert got["coverage"] == pytest.approx(0.8)
    assert segments_ms((0, {"engine": 0.0}), busy_s=0.02) == {}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_collate_busy_share(mode):
    other = "eval" if mode == "train" else "train"
    name = f"collate_busy_pct.{mode}"
    w = Window(mode=mode, window_s=2.0, metas=[{"real_count": 8}] * 4)
    assert read_metric(name, w) is None          # the parent's metas
    w.metas = [dict(collate_s=0.3, collate_pid=11),
               dict(collate_s=0.5, collate_pid=12),
               dict(collate_s=0.2, collate_pid=11)]
    assert read_metric(name, w) == pytest.approx(100.0 * 1.0 / (2 * 2.0))
    assert read_metric(f"collate_busy_pct.{other}", w) is None
    w.window_s = 0.0
    assert read_metric(name, w) is None


def test_a_traced_tiny_run_reads_the_programs_segments(tiny, tmp_path):
    """A tiny train cell on the CPU through ProgramTracer with the
    program's tracing on: the segments are read over the traced steps
    alone, and the collate share is reported."""
    code = f"""
import sys, time, json, torch
sys.path.insert(0, {str(cell.ROOT)!r}); sys.path.append({str(cell.CHECKOUT)!r})
sys.path.insert(0, {str(cell.ROOT / 'tests')!r})
from conftest import shrink
from graphvqa_tpu_torch.core import profiling
from harness import main, train_cell
from harness.program_trace import ProgramTracer
tracers = []
def tracer(*a, **k):
    tracers.append(ProgramTracer(*a, **k))
    return tracers[-1]
train_cell.Tracer = tracer
profiling.enable(True)
res = main.result("gat.train.gqa_b200", 5, 6.0, True, torch.device("cpu"),
                  time.perf_counter(), overrides=shrink)
s = tracers[-1].summary
print(json.dumps([res["correct"], sorted(res["metrics"]),
                  len(tracers[-1].metas), s["segments_ms"]]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(__import__("os").environ,
                                  TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    correct, metrics, traced, seg = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert correct and "collate_busy_pct.train" in metrics
    assert seg["steps"] == traced == 2
    assert set(seg["ms"]) == {"encoders", "program_decoder", "engine",
                              "classifier", "loss_backward", "optimizer"}
