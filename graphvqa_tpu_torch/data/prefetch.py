"""Background-thread batch prefetching (the port's own copy of
``graphvqa_tpu/data/prefetch.py``).

The reference hides host-side collate latency behind N dataloader worker
processes (mainExplain_gat.py:201-209). Here the heavy per-batch work (C++
packing + tokenization) runs on a background thread that stays ahead of
the device, overlapping host packing with the card's steps.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

from graphvqa_tpu_torch.core import profiling

T = TypeVar("T")

_STOP = object()


def prefetch(iterable: Iterable[T], depth: int = 4) -> Iterator[T]:
    """Iterate ``iterable`` on a background thread with a bounded queue;
    the consumer's wait for each item is the span ``gvqa.prefetch.get``."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(_STOP)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        with profiling.span("gvqa.prefetch.get"):
            item = q.get()
        if item is _STOP:
            break
        yield item
    if err:
        raise err[0]
    t.join()
