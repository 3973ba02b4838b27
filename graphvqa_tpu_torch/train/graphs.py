"""CUDA graphs of the train and eval steps, one per batch shape: the port's
counterpart of the JAX package's ``jax.jit`` (one compiled program per rung
of the dense ladder, ``data/dataset.py``) and of the single dispatch of its
``lax.scan`` steps.

:class:`StepGraphs` runs a step body per call, keyed on the batch's shapes,
dtypes and static sizes (:func:`batch_key`):

* the first call at a key runs the body eagerly on a side stream. This
  warm-up is a real step, and it sets up what is made lazily outside any
  capture: cuBLAS workspaces and the GAT kernels' shared-memory attributes;
* the second call copies the batch into static tensors, captures the body
  over them into a CUDA graph and replays it once;
* every later call copies its batch into those tensors and replays.

A call returns the graph's own output tensors, which a later replay writes
over (module doc below): a caller that keeps outputs past its next step
copies them. ``train_one_epoch`` and ``multi_step`` copy the train
metrics, and ``make_eval_step`` clones each request's answer.

The generators the body draws from (dropout, LCGN's context features) are
registered with each graph, so a replay draws what the eager body would draw
from the same generator state and advances it as far. A graph holds the
addresses of the tensors it read at capture, so the state and generators a
:class:`StepGraphs` is bound to (``bind``) must stay the same objects; when
any changes, its graphs are dropped and the next call warms up again.

All graphs on a device share one memory pool, so one graph's replay may
write its work tensors where another graph keeps its outputs or
gradients, and PyTorch promises a shared pool only to graphs replayed in
the order of their capture. Rungs replay in any order here, which is sound
because no replay reads pool memory that it did not write itself: a body
reads its static inputs (made outside the pool), the parameters, moments
and buffers (made outside it and updated in place) and what it wrote
earlier in the same replay. What a replay leaves in the pool, its outputs
(the train step's metrics and gradients among them), holds its values only
until the next replay of any rung: read or copy them before that.
(``chip_smoke.py`` phase 14 holds the main rung's replays, interleaved
with the bumped rung's, to the eager step.)

The GAT kernels count their launches on the card (``ops/gat_round.py``),
so replays count as eager calls do. A replay runs no Python, so
``gat_round_backward.counter`` is pointed at the replayed graph's counter,
to be read after the replay.

A body may be a sequence of segments with a host call between each two:
the data-parallel step (``parallel/data_parallel.py``) is graph A (forward,
backward, gradients packed into one buffer), ``dist.all_reduce`` of that
buffer through gloo, which no graph can hold, then graph B (the reduced
buffer unpacked, Adam). Each segment is captured into a graph of its own
in the shared pool; the key keeps one warm-up and one capture. Streams:
a warm-up runs every segment and the host calls on the side stream, which
waits for the current stream before and is waited for after; a capture
records each segment on the side stream and runs nothing; a replay
launches each graph on the current stream and issues the host calls there
too. gloo's all-reduce of a CUDA tensor waits for the current stream's
work (graph A) before it copies the buffer to the host, and makes the
current stream wait for its copy back before graph B is launched, so no
event of this module's own is needed. The buffer between segments is made
outside the pool, so graph B reads no pool memory that it did not write
itself. Over NCCL the all-reduce is captured inside the one graph.

The edge-sharded steps run collectives inside their forward and backward
(``parallel/collectives.py:AssembleRows``), through gloo, between no
segments of their own: they stay eager, and a batch with an edge group is
refused here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from graphvqa_tpu_torch.ops import gat_round as gr

# per device index: the memory pool of every step graph, and the side stream
# that warm-ups and captures run on
_POOLS: Dict[int, Any] = {}
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    index = _index(device)
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    return _STREAMS[index]


def cuda_graph_capture(fn: Callable[[], Any],
                       generators: Sequence[torch.Generator],
                       device: torch.device) -> Callable[[], Any]:
    """Capture ``fn()`` into a CUDA graph on ``device``'s side stream, in
    the shared pool, with ``generators`` registered -> ``replay()``, which
    replays the graph and returns ``fn``'s (static) outputs. A capture that
    fails raises, naming the op that broke it."""
    index = _index(device)
    if index not in _POOLS:
        _POOLS[index] = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    # thread_local: the prefetch thread may copy batches to the card
    # meanwhile, on its own stream
    with torch.cuda.graph(graph, pool=_POOLS[index],
                          stream=_side_stream(device),
                          capture_error_mode="thread_local"):
        out = fn()

    def replay():
        graph.replay()
        return out

    return replay


def batch_key(batch) -> tuple:
    """The shapes and dtypes of a batch container's tensors and its static
    fields (graph count, dense widths), in field order."""
    key = []
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, torch.Tensor):
            key.append((tuple(v.shape), v.dtype))
        elif dataclasses.is_dataclass(v):
            key.append(batch_key(v))
        else:
            key.append(v)
    return tuple(key)


def map_tensors(fn, obj):
    """``obj`` (tensors in dataclasses, dicts, tuples and lists) with ``fn``
    applied to each tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    return obj


def _tensors(obj) -> list:
    out = []
    map_tensors(out.append, obj)
    return out


def _chain(segments: Sequence[Callable[[], Any]],
           host: Optional[Callable[[], None]]):
    """Each of ``segments`` in order with ``host()`` between each two -> the
    first's outputs, or with several segments a tuple of each one's."""
    outs = [segments[0]()]
    for segment in segments[1:]:
        host()
        outs.append(segment())
    return outs[0] if len(outs) == 1 else tuple(outs)


@dataclasses.dataclass
class _Graph:
    """One key's graphs: its static batch, one replay per segment and its
    backward kernel's counter."""
    static: Any = None
    replays: Optional[list] = None
    backward_counter: Optional[torch.Tensor] = None


class StepGraphs:
    """One graph per batch key for a step body (module doc).
    ``capture_fn(fn, generators, device)`` turns a body into a replay
    (:func:`cuda_graph_capture`; tests pass their own). ``warm_ups``,
    ``captures``, ``replays`` count the calls of each kind, and
    ``capture_seconds`` holds each key's capture time on the host clock."""

    def __init__(self, capture_fn: Optional[Callable] = None):
        self.capture_fn = capture_fn or cuda_graph_capture
        self.graphs: Dict[tuple, _Graph] = {}
        self.bound: tuple = ()
        self.warm_ups = self.captures = self.replays = 0
        self.capture_seconds: Dict[tuple, float] = {}

    def __call__(self, body, batch,
                 generators: Sequence[Optional[torch.Generator]] = (),
                 bind: Sequence[Any] = (),
                 host: Optional[Callable[[], None]] = None):
        """``body(batch)`` through the key's graph -> its outputs (the
        graph's own tensors on a replay: module doc).
        ``body`` may be a sequence of segments instead: ``body[0](batch)``,
        then ``host()`` and ``body[1]()``, and so on, each segment a graph
        of its own and ``host`` run between them on every call -> a tuple
        of each segment's outputs.
        ``bind``: the objects whose tensors the body reads (the train
        state); ``generators``: those it draws from (None entries skipped)."""
        if batch.graphs.edge_group is not None:
            raise ValueError(
                "an edge-sharded batch runs collectives inside its forward "
                "and backward, through gloo, which a CUDA graph cannot "
                "hold: the edge steps of parallel/ stay eager")
        segments = (body,) if callable(body) else tuple(body)
        generators = tuple(g for g in generators if g is not None)
        bound = tuple(bind) + generators
        if len(bound) != len(self.bound) or any(
                a is not b for a, b in zip(bound, self.bound)):
            self.graphs.clear()
            self.capture_seconds.clear()
            self.bound = bound
        key = batch_key(batch)
        entry = self.graphs.get(key)
        if entry is None:
            self.graphs[key] = _Graph()
            self.warm_ups += 1
            return self._warm_up(segments, batch, host)
        if entry.replays is None:
            self._capture(entry, key, segments, batch, generators)
        else:
            for dst, src in zip(_tensors(entry.static), _tensors(batch)):
                dst.copy_(src)
        out = _chain(entry.replays, host)
        self.replays += 1
        if entry.backward_counter is not None:
            gr.gat_round_backward.counter = entry.backward_counter
        return out

    def _warm_up(self, segments, batch, host):
        run = [lambda: segments[0](batch), *segments[1:]]
        device = batch.questions.device
        if device.type != "cuda":
            return _chain(run, host)
        stream, current = _side_stream(device), torch.cuda.current_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = _chain(run, host)
        current.wait_stream(stream)
        return out

    def _capture(self, entry, key, segments, batch, generators):
        entry.static = map_tensors(torch.clone, batch)
        counter = gr.gat_round_backward.counter
        device = batch.questions.device
        t0 = time.perf_counter()
        run = [lambda: segments[0](entry.static), *segments[1:]]
        entry.replays = [self.capture_fn(fn, generators, device)
                         for fn in run]
        self.capture_seconds[key] = time.perf_counter() - t0
        self.captures += 1
        if gr.gat_round_backward.counter is not counter:
            entry.backward_counter = gr.gat_round_backward.counter
