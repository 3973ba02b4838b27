"""Share of the traced sub-window of the train cell during which no
operation ran on the card (its operations' intervals merged)."""


def read(run):
    if run.mode != "train" or not run.trace or not run.trace["ops"]:
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
