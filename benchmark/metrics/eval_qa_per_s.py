"""Questions answered in the window (answers on the host) over the
window's seconds (host clock)."""


def read(run):
    if run.mode != "eval" or run.window_s <= 0:
        return None
    return run.questions / run.window_s
