"""The traced sub-window: torch.profiler over a few dozen steps of the
window, reduced in memory to what the per-layer metrics read (no trace
file is written).

Device time is the union of the device's operation intervals (kernels,
copies, fills; not the mirrors of host spans), merged so that overlapping
operations count once; the idle
share is the rest of the sub-window. Each idle gap is named by the host
operation that was running when it began (the innermost one), the
benchmark's own spans among them. The data path's stall is the part of the
idle time during which the host waits for the next batch (the span
``NEXT_BATCH`` around each ``next()`` on the batch iterator): a wait that
the card spends on the previous step's work is not counted.
"""
from __future__ import annotations

import time

import torch

# the host's calls that put work on the card: kernel launches, graph
# launches, and the copies and fills the caching allocator's users enqueue
# (the list ``chip_smoke.py`` counts)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")
GAT_FORWARD = "gat_round_kernel"
GAT_BACKWARD = "gat_round_backward_kernel"
NEXT_BATCH = "bench.next_batch"


def warm_up_profiler(on_device: bool) -> None:
    """Start and stop the profiler once, in set-up: its first start on the
    card initialises CUPTI, seconds that would otherwise fall in the
    window."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if on_device:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.zeros(1, device="cuda" if on_device else "cpu").add_(1)


class Tracer:
    """Profiles ``steps`` steps of the window, from the first step after
    ``start_s`` seconds of it; ``step(i, meta)`` is called before step i
    runs. The part of the window before the profiler starts is what the
    host-clock per-layer metrics read (``host``: its seconds and steps), so
    that the profiler's cost falls outside them; the profile is
    reduced after the window closes (``finish``)."""

    def __init__(self, run, t0: float, start_s: float, steps: int,
                 on_device: bool):
        self.run, self.t0, self.start_s, self.steps = run, t0, start_s, steps
        self.on_device = on_device
        self.prof, self.metas, self.first, self.host = None, [], None, None
        self.t_start = self.t_stop = None
        self.summary = None

    def step(self, i: int, meta) -> None:
        if self.first is None and time.perf_counter() - self.t0 >= self.start_s:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.on_device:
                acts.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self.first = i
            self.host = (time.perf_counter() - self.t0, i)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t_start = time.perf_counter()
        if self.first is not None and i == self.first + self.steps:
            self.stop()
        if self.prof is not None and self.t_stop is None:
            self.metas.append(meta)

    def stop(self) -> None:
        if self.prof is None or self.t_stop is not None:
            return
        if self.on_device:
            torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.stop()

    def finish(self) -> None:
        """After the window: stop if still running, reduce the profile."""
        self.stop()
        if self.prof is not None:
            self.summary = summarize(self.prof, self.t_stop - self.t_start)
            self.prof = None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarize(prof, window_s: float) -> dict:
    """Device busy seconds, kernel seconds by name, host launch calls, the
    longest idle gaps and the idle seconds spent waiting for a batch of one
    profiled sub-window."""
    from torch.autograd import DeviceType
    dev, host = [], []
    launches = 0
    for ev in prof.events():
        r = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            # a host span's mirror on the device's timeline covers the
            # operations launched inside it and the gaps between them
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith("bench.")):
                dev.append((r.start, r.end, ev.name))
        elif ev.device_type == DeviceType.CPU:
            host.append((r.start, r.end, ev.name))
            if ev.name in HOST_LAUNCH_CALLS:
                launches += 1
    by_name = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    merged = _merge([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) / 1e6
    gaps = []
    if merged:
        start = min(s for s, _, _ in host) if host else merged[0][0]
        edges = [start] + [x for iv in merged for x in iv]
        end = max([e for _, e, _ in host] + [merged[-1][1]])
        edges.append(end)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, a))
    waits = _merge([(s, e) for s, e, n in host if n == NEXT_BATCH])
    idle = sorted((a, a + length) for length, a in gaps)
    data_wait = _overlap(idle, waits) / 1e6
    gaps.sort(reverse=True)
    named = []
    for length, at in gaps[:10]:
        inner = [(e - s, n) for s, e, n in host if s <= at < e]
        named.append([min(inner)[1] if inner else "host idle", length / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=window_s, busy_s=busy, kernel_s=by_name,
                host_launches=launches, device_ops=[list(t) for t in top],
                idle_gaps=named, ops=len(dev), data_wait_idle_s=data_wait)
