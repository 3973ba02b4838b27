"""The host's launch calls (kernel and graph launches, async copies and
fills, as ``harness/trace.py`` lists them) per train step over the traced
sub-window, from the profiler's host events."""


def read(run):
    if run.mode != "train" or not run.trace or not run.trace_metas:
        return None
    return run.trace["host_launches"] / len(run.trace_metas)
