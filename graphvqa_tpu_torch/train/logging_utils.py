"""Host-side progress meters and the run's provenance stamp (port of
``graphvqa_tpu/train/logging_utils.py``: ``get_sha``, ``AverageMeter`` and
``ProgressMeter``, what ``train_one_epoch`` and ``validate`` print)."""
from __future__ import annotations

import logging
import pathlib
import subprocess
from typing import List


def get_sha() -> str:
    """Git provenance stamp for the run log header: commit, whether the tree
    has changes, branch ("N/A" outside a git checkout)."""
    cwd = pathlib.Path(__file__).resolve().parent

    def run(cmd):
        return subprocess.check_output(
            cmd, cwd=cwd, stderr=subprocess.DEVNULL).decode("ascii").strip()

    sha = branch = "N/A"
    diff = "clean"
    try:
        sha = run(["git", "rev-parse", "HEAD"])
        diff = ("has uncommitted changes"
                if run(["git", "diff-index", "HEAD"]) else "clean")
        branch = run(["git", "rev-parse", "--abbrev-ref", "HEAD"])
    except (OSError, subprocess.CalledProcessError):
        pass
    return f"sha: {sha}, status: {diff}, branch: {branch}"


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    def __init__(self, num_batches: int, meters: List[AverageMeter],
                 prefix: str = ""):
        num_digits = len(str(num_batches // 1))
        self.batch_fmtstr = ("[{:" + str(num_digits) + "d}/"
                             + str(num_batches) + "]")
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        line = "\t".join(entries)
        print(line)
        logging.info(line)
