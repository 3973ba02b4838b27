"""Share of the traced sub-window of the train cell in which the card is idle
while the host waits in ``next()`` on the batch iterator (rank 0 on several
ranks): the data path's stall. The part of a wait during which the card
still runs the previous step is not counted."""


def read(run):
    if run.mode != "train" or not run.trace or not run.trace["ops"]:
        return None
    t = run.trace
    return 100.0 * t["data_wait_idle_s"] / t["window_s"]
