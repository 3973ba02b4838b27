"""The GAT round forward kernel's share of its roofline in the eval cell:
the least time its launches of the traced sub-window need (their least
bytes, ``counts/gat_bytes.py``, at 3.35 TB/s) over their device time."""


def read(run):
    if run.mode != "eval" or not run.trace:
        return None
    busy = sum(v for k, v in run.trace["kernel_s"].items()
               if run.gat_kernels[0] in k)
    if not busy or not run.gat_bytes[0]:
        return None
    return 100.0 * run.gat_bytes[0] / run.peak_bytes_per_s / busy
