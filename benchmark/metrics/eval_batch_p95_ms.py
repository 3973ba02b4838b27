"""95th percentile (nearest rank) of the window's eval batches, each timed
on the host clock from the moment the loop hands it to the eval step until
its answers are on the host."""


def read(run):
    import math
    if run.mode != "eval" or not run.batch_s:
        return None
    ordered = sorted(run.batch_s)
    return 1e3 * ordered[math.ceil(0.95 * len(ordered)) - 1]
