"""Share of the collate workers' time that the train cell's window kept them
collating: the window's batches' collate seconds (``collate_s``, timed by
the program where each batch was collated) over the workers that collated
them (``collate_pid``) times the window's seconds. Near 100 % the data path
is saturated and the card will wait for batches."""


def read(run):
    if run.mode != "train" or run.window_s <= 0:
        return None
    timed = [m for m in run.metas if "collate_s" in m]
    if not timed:
        return None
    workers = len({m["collate_pid"] for m in timed})
    return 100.0 * sum(m["collate_s"] for m in timed) / (workers
                                                          * run.window_s)
