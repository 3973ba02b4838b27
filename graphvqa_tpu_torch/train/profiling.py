"""Throughput counters (port of
``graphvqa_tpu/train/profiling.py:ThroughputMeter``): QA pairs/s and edge
traversals/s (real edges times engine rounds) on the host clock."""
from __future__ import annotations

import time


class ThroughputMeter:
    def __init__(self, engine_rounds: int = 5):
        self.engine_rounds = engine_rounds
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._pairs = 0
        self._edges = 0

    def update(self, num_questions: int, num_real_edges: int):
        self._pairs += num_questions
        self._edges += num_real_edges * self.engine_rounds

    @property
    def qa_pairs_per_s(self) -> float:
        return self._pairs / max(time.perf_counter() - self._t0, 1e-9)

    @property
    def edge_traversals_per_s(self) -> float:
        return self._edges / max(time.perf_counter() - self._t0, 1e-9)

    def summary(self) -> str:
        return (f"{self.qa_pairs_per_s:.1f} qa/s, "
                f"{self.edge_traversals_per_s:.3e} edges/s")
