"""The host's launch calls (kernel and graph launches, async copies and
fills, as ``harness/trace.py`` lists them) per eval step over the traced
sub-window, from the profiler's host events."""


def read(run):
    if run.mode != "eval" or not run.trace or not run.trace_metas:
        return None
    return run.trace["host_launches"] / len(run.trace_metas)
