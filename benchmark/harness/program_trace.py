"""The program's own spans and device segments in a traced run: what the
port records about itself when its tracing is on
(``graphvqa_tpu_torch/core/profiling.py``), reduced beside the benchmark's
own reduction of the same profile (``harness/trace.py``).

* ``segments_ms``: each device segment's milliseconds per step over the
  traced steps (the stamps of the replayed graphs: encoders, decoders,
  engine, classifier, loss and backward, optimizer, all-reduce), and
  ``coverage``: the segments' sum over the profiler's device-busy time per
  step of the same sub-window;
* ``idle_by_span``: the device's idle seconds, each gap put down to the
  innermost ``gvqa.`` or ``bench.`` span open on the issuing thread (the
  thread that calls the step) when the gap began, or to ``outside`` when
  none is open. Another thread's host calls (the prefetch thread's copies)
  name no gap here.

:class:`ProgramTracer` is ``harness/trace.py:Tracer`` that zeroes the
segments before the profiler starts and reads them after it stops (both
points already wait for the card) and adds both fields to its summary.
``benchmark/trace_program.py`` runs a cell with it and the program's
tracing on.
"""
from __future__ import annotations

import time

from harness.trace import Tracer, _merge

SPAN_PREFIXES = ("gvqa.", "bench.")
STEP_SPAN = "gvqa.step"


def device_intervals(events) -> list:
    """The device's operations (start, end), as ``harness/trace.py``
    counts them: host spans' mirrors on the device left out, the program's
    and the benchmark's alike."""
    from torch.autograd import DeviceType
    out = []
    for ev in events:
        if ev.device_type == DeviceType.CUDA and not (
                getattr(ev, "is_user_annotation", False)
                or ev.name.startswith(SPAN_PREFIXES)):
            out.append((ev.time_range.start, ev.time_range.end))
    return out


def idle_gaps(events) -> list:
    """(start, end) of each stretch of the sub-window with no device
    operation: from the first host event to the last event, as
    ``harness/trace.py:summarize`` takes them."""
    from torch.autograd import DeviceType
    merged = _merge(device_intervals(events))
    if not merged:
        return []
    host = [ev.time_range for ev in events
            if ev.device_type == DeviceType.CPU]
    start = min(r.start for r in host) if host else merged[0][0]
    end = max([r.end for r in host] + [merged[-1][1]])
    edges = [start] + [x for iv in merged for x in iv] + [end]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def issuing_thread(events):
    """The thread that calls the step: the one holding the ``gvqa.step``
    spans, else the benchmark's ``bench.next_batch`` spans; None if
    neither was recorded."""
    from torch.autograd import DeviceType
    for name in (STEP_SPAN, "bench.next_batch"):
        threads = [getattr(ev, "thread", 0) for ev in events
                   if ev.device_type == DeviceType.CPU and ev.name == name]
        if threads:
            return max(set(threads), key=threads.count)
    return None


def idle_by_span(events) -> dict:
    """Idle seconds by the innermost ``gvqa.``/``bench.`` span open on the
    issuing thread where each gap began (``outside``: none open)."""
    from torch.autograd import DeviceType
    thread = issuing_thread(events)
    spans = [(ev.time_range.start, ev.time_range.end, ev.name)
             for ev in events
             if ev.device_type == DeviceType.CPU
             and ev.name.startswith(SPAN_PREFIXES)
             and getattr(ev, "thread", 0) == thread]
    out = {}
    for a, b in idle_gaps(events):
        open_ = [(e - s, n) for s, e, n in spans if s <= a < e]
        key = min(open_)[1] if open_ else "outside"
        out[key] = out.get(key, 0.0) + (b - a) / 1e6
    return out


def step_call_idle_s(by_span: dict) -> float:
    """The idle seconds that began under ``gvqa.step`` or a span of its
    own (its warm-up, capture, copy-in, replay, host call)."""
    return sum(v for k, v in by_span.items()
               if k == STEP_SPAN or k.startswith(STEP_SPAN + "."))


def segments_ms(segments, busy_s: float) -> dict:
    """(steps, {segment: seconds}) as the program reads them -> ms per
    step of each segment that ran, and the segments' sum over the device's
    busy time per step (``coverage``)."""
    steps, seconds = segments
    if not steps:
        return {}
    per = {k: 1e3 * s / steps for k, s in seconds.items() if s}
    out = dict(steps=steps, ms=per)
    if busy_s > 0:
        out["coverage"] = sum(per.values()) / (1e3 * busy_s / steps)
    return out


class ProgramTracer(Tracer):
    """``Tracer`` that reads the program's segments over the traced steps
    and adds ``segments_ms`` and ``idle_by_span`` to its summary."""

    segments = None

    def step(self, i: int, meta) -> None:
        from graphvqa_tpu_torch.core import profiling
        # zeroed before the tracer's synchronize and start, where it will
        # start; again after the start when the clock crossed in between
        due = (self.first is None
               and time.perf_counter() - self.t0 >= self.start_s)
        if due:
            profiling.reset_segments()
        idle = self.prof is None
        super().step(i, meta)
        if idle and self.prof is not None and not due:
            profiling.reset_segments()

    def stop(self) -> None:
        from graphvqa_tpu_torch.core import profiling
        running = self.prof is not None and self.t_stop is None
        super().stop()
        if running:
            self.segments = profiling.read_segments()

    def finish(self) -> None:
        prof = self.prof
        super().finish()
        if prof is None:
            return
        events = prof.events()
        by_span = idle_by_span(events)
        self.summary.update(
            segments_ms=segments_ms(self.segments or (0, {}),
                                    self.summary["busy_s"]),
            idle_by_span=by_span, step_call_idle_s=step_call_idle_s(by_span))
