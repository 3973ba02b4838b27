"""Questions trained in the window, summed over ranks, over the window's
seconds (host clock; every step issued in the window has finished when it
closes)."""


def read(run):
    if run.mode != "train" or run.window_s <= 0:
        return None
    return run.questions / run.window_s
