"""Seconds from the start of the process to the first timed step: imports,
traffic written and read, the model and its weights, warm-ups and
captures of every batch shape the window reaches."""


def read(run):
    return run.setup_s
