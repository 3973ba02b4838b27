"""The program's meters and its tracing.

:class:`ThroughputMeter` (port of
``graphvqa_tpu/train/profiling.py:ThroughputMeter``): QA pairs/s and edge
traversals/s (real edges times engine rounds) on the host clock.

Tracing has one switch, :func:`enable`, off by default. When it is on:

* :func:`span` opens a ``torch.profiler.record_function`` range named
  ``gvqa.<layer>.<what>`` at a layer boundary. The range lands, on the
  profiler's own clock, in whichever profile is running (a benchmark's
  tracer, the CLI's ``--profile-dir`` trace), beside the device's
  operations; with no profile running it records nothing;
* :func:`begin` and :func:`stamp` split each step into the device segments
  of :data:`SEGMENTS`. On a card a stamp is a one-thread kernel
  (``csrc/segment_stamp.cu``) that reads the card's nanosecond clock where
  its stream reaches it and adds the time since the previous stamp to its
  segment; :func:`begin` restarts the clock and counts a step. The stamps
  are ordinary launches, so a CUDA graph captured with tracing on holds
  them as nodes and each replay runs them between the modules' kernels:
  the segments split a replay that the host sees as one call. The sums live
  in one int64 tensor per card, made outside any graph pool at the first
  stamp there (an eager call: a step warms up before it captures).
  :func:`reset_segments` zeroes them on the stream and :func:`read_segments`
  reads them, the only call that waits for the card. On the CPU the same
  calls add host-clock time, so tests run them.

When it is off, :func:`span` returns one shared no-op context and a stamp
returns at once, so a step captured with tracing off holds no
instrumentation node; ``train/graphs.py:StepGraphs`` drops its graphs when
the switch changes, as it does when its bound state changes.
"""
from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Dict, Tuple

import torch
from torch.profiler import record_function

# the device segments, in step order: the model's modules (forward and
# greedy sample), the loss and backward, Adam with the step's metrics, and
# the data-parallel step's all-reduce; ``engine_messages`` is the part of
# ``engine`` that builds and sums the edge messages (GINE's rounds stamp it)
SEGMENTS = ("encoders", "program_decoder", "engine", "engine_messages",
            "classifier", "full_answer_decoder", "loss_backward", "optimizer",
            "allreduce")
_INDEX = {name: k for k, name in enumerate(SEGMENTS)}
# csrc/segment_stamp.cu's launcher: {function: (argtypes, restype)}
_STAMP = {"segment_stamp_launch": (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)}

_on = False
_NULL = contextlib.nullcontext()
# per card index: [clock at the last stamp, steps begun, ns per segment]
_words: Dict[int, torch.Tensor] = {}
# the same layout for stamps on the CPU, on the host clock
_host = [0] * (2 + len(SEGMENTS))


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


def enable(on: bool = True) -> None:
    """Turn the program's spans and device segments on or off."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A profiler range named ``name`` while tracing is on; otherwise one
    shared context that does nothing."""
    return record_function(name) if _on else _NULL


def begin(device: torch.device) -> None:
    """A step starts on ``device``: the clock restarts (the time since the
    last stamp goes to no segment) and the step count grows by one."""
    if _on:
        _mark(-1, device)


def stamp(segment: str, device: torch.device) -> None:
    """The time on ``device`` since its previous stamp goes to
    ``segment`` (one of :data:`SEGMENTS`)."""
    if _on:
        _mark(_INDEX[segment], device)


def reset_segments() -> None:
    """Zero every segment and step count (on the cards, on the current
    stream: nothing waits)."""
    for words in _words.values():
        words[1:].zero_()
    _host[1:] = [0] * (len(_host) - 1)


def read_segments() -> Tuple[int, Dict[str, float]]:
    """(steps begun, {segment: seconds}) since :func:`reset_segments`,
    summed over the cards and the host clock. Waits for the work queued on
    the cards."""
    rows = [words.tolist() for words in _words.values()] + [_host]
    return (sum(r[1] for r in rows),
            {name: sum(r[2 + k] for r in rows) / 1e9
             for k, name in enumerate(SEGMENTS)})


def _mark(k: int, device: torch.device) -> None:
    if device.type != "cuda":
        now = time.perf_counter_ns()
        if k < 0:
            _host[1] += 1
        else:
            _host[2 + k] += now - _host[0]
        _host[0] = now
        return
    # imported here: ops sits above core (its kernels' seam builds the stamp)
    from graphvqa_tpu_torch.ops import cuda_lib
    index = cuda_lib.device_index(device)
    words = _words.get(index)
    if words is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the first segment stamp on {device} falls inside a CUDA "
                f"graph capture: run the step once eagerly with tracing on "
                f"before capturing it")
        # a normal tensor even when the first stamp is an eval step's, so
        # that reset_segments may zero it anywhere
        with torch.inference_mode(False):
            words = _words[index] = torch.zeros(
                2 + len(SEGMENTS), dtype=torch.int64, device=device)
    cuda_lib.launch(cuda_lib.bind("segment_stamp", _STAMP)
                    .segment_stamp_launch, (words.data_ptr(), k), device,
                    "segment stamp")
