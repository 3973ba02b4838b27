"""The whole train step's share of the cards' peak: the benchmark's count of
the matrix products the batches of every rank need (``counts/flops.py``)
over the seconds they took times the cards times 989 TFLOP/s (H100 SXM,
bf16, dense), over the part of the window the host-clock metrics read.
Float32 products count against the same peak."""


def read(run):
    if run.mode != "train" or run.host_s <= 0 or not run.host_flops:
        return None
    return 100.0 * run.host_flops / (run.host_s * run.chips * run.peak_flops)
