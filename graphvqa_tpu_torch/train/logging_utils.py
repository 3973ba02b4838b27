"""Host-side progress meters (port of ``graphvqa_tpu/train/logging_utils.py``:
``AverageMeter`` and ``ProgressMeter``, what ``train_one_epoch`` prints)."""
from __future__ import annotations

import logging
from typing import List


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
