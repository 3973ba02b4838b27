"""CUDA graphs of the train and eval steps, one per batch shape: the port's
counterpart of the JAX package's ``jax.jit`` (one compiled program per rung
of the dense ladder, ``data/dataset.py``) and of the single dispatch of its
``lax.scan`` steps.

:class:`StepGraphs` runs a step body per call, keyed on the batch's shapes,
dtypes and static sizes (:func:`batch_key`):

* the first call at a key runs the body eagerly on a side stream. This
  warm-up is a real step, and it sets up what is made lazily outside any
  capture: cuBLAS workspaces and the hand-written kernels' shared-memory
  attributes;
* the second call copies the batch into static tensors, captures the body
  over them into a CUDA graph (a chain of them where the body reaches the
  host, below) and replays it once;
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

The graphs alive on a device share one memory pool, so one graph's
replay may write its work tensors where another graph keeps its outputs
or gradients, and PyTorch promises a shared pool only to graphs replayed
in the order of their capture. Rungs replay in any order here, which is
sound because no step's replay reads pool memory that it did not write
itself: a body reads its static inputs (made outside the pool), the
parameters, moments and buffers (made outside it and updated in place)
and what it wrote earlier in the same replay. What a replay leaves in the
pool, its outputs (the train step's metrics and gradients among them),
holds its values only until the next replay of any rung: read or copy
them before that.
(``chip_smoke.py`` phase 14 holds the main rung's replays, interleaved
with the bumped rung's, to the eager step.)

The hand-written kernels count their launches on the card
(``ops/cuda_lib.py``), so replays count as eager calls do, and this module
knows no kernel.

A step reaches the host where it runs a collective that no graph can
hold: the data-parallel step's all-reduce (``parallel/data_parallel.py``)
and the edge-sharded steps' maxima and row assemblies, forward and
backward (``parallel/collectives.py``), through gloo. Such a collective is
a host call (:func:`host_call`), and a host call inside a capture is a
cut: the capture ends the current graph, keeps the call and begins the
next graph in the same pool, so one key holds a chain of segments, graph
0, host call 0, graph 1, and so on, in the order the body reached them,
and a replay runs that chain. The data-parallel step over gloo has one
cut; at gat_config()'s five GAT rounds a data x edge train step has 18
(11 in the forward, 6 in the backward, the step's all-reduce) and an edge
eval request 11. Over NCCL every
collective runs inside the one graph, as JAX's ``shard_map`` step runs
inside one program. A host call's tensor is the step's own buffer for
that call (:func:`host_buffer`): made at the key's warm-up, outside the
pool, and the same tensor for the graphs' life, so the graph before the
cut writes it, the host call reduces it in place and the graph after the
cut reads it. A cut in a backward falls on autograd's device thread,
which ends a graph that the main thread began, or begins one that the
main thread ends; CUDA allows that only in the relaxed capture mode, so a
key whose warm-up made host calls captures in that mode. Streams: a
warm-up runs the body and its host calls on the side stream; a capture
records each segment on the side stream and runs no host call; a replay
launches each graph on the current stream and issues the host calls
there too. gloo's all-reduce of a CUDA tensor waits for the current
stream's work (the graph before it) before it copies the tensor to the
host, and makes the current stream wait for its copy back before the
next graph is launched, so no event of this module's own is needed.

Inside one step the graphs do read pool memory they did not write: a
segment reads what the segments before it saved (activations for the
backward, among them). That is sound because a
key's segments replay in capture order with only their host calls
between them, and no other rung's replay falls inside a step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from graphvqa_tpu_torch.core import profiling

# per device index: the memory pool of the step graphs (with a weak set of
# those alive), and the side stream that warm-ups and captures run on
_POOLS: Dict[int, tuple] = {}
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    index = _index(device)
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    return _STREAMS[index]


def _pool(index: int) -> tuple:
    """(handle, live graphs) of the device's graph pool; a new pool when no
    graph of the old one is alive. A pool outlives its graphs while their
    outputs hold its memory, and PyTorch lets no new graph into a pool
    whose graphs are all gone (a step's graphs go with the step)."""
    pool = _POOLS.get(index)
    if pool is None or not pool[1]:
        pool = _POOLS[index] = (torch.cuda.graph_pool_handle(),
                                weakref.WeakSet())
    return pool


def cuda_graph_capture(fn: Callable[[Callable], Any],
                       generators: Sequence[torch.Generator],
                       device: torch.device,
                       mode: str = "thread_local") -> Callable[[], Any]:
    """Capture ``fn(cut)`` into CUDA graphs on ``device``'s side stream, in
    the shared pool, each with ``generators`` registered; ``fn`` calls
    ``cut(host)`` where the body reaches a host call, which ends the
    current graph, keeps ``host`` and begins the next (module doc).
    -> ``replay()``, which replays the graphs in order with each kept host
    call between two and returns ``fn``'s (static) outputs. ``mode`` is
    CUDA's capture mode: the default lets the prefetch thread copy batches
    to the card meanwhile, on its own stream; 'relaxed' lets a cut fall on
    another thread. A capture that fails raises, naming the op that broke
    it."""
    pool, live = _pool(_index(device))
    stream = _side_stream(device)
    graphs: List[torch.cuda.CUDAGraph] = []
    hosts: List[Callable[[], None]] = []

    def begin():
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool, capture_error_mode=mode)
        graphs.append(graph)
        live.add(graph)

    def end():
        # a capture ends on the stream it began on, from any thread
        with torch.cuda.stream(stream):
            graphs[-1].capture_end()

    def cut(host):
        end()
        hosts.append(host)
        begin()

    # as torch.cuda.graph: the pool starts from what the cache can free
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    begin()
    try:
        with torch.cuda.stream(stream):
            out = fn(cut)
    finally:
        end()

    def replay():
        graphs[0].replay()
        for host, graph in zip(hosts, graphs[1:]):
            with profiling.span("gvqa.step.host_call"):
                host()
            graph.replay()
        return out

    return replay


@dataclasses.dataclass
class _Run:
    """A body being run by :class:`StepGraphs` outside a replay: its key's
    host-call buffers (in call order), the capture's ``cut`` (None in a
    warm-up, whose host calls run at once), and the buffers handed out and
    host calls made so far."""
    buffers: list
    cut: Optional[Callable] = None
    at: int = 0
    calls: int = 0


# the run in progress: a module's, not a thread's, because a cut in a
# backward is reached on autograd's device thread
_RUN: Optional[_Run] = None


@contextlib.contextmanager
def _running(run: _Run):
    global _RUN
    before, _RUN = _RUN, run
    try:
        yield run
    finally:
        _RUN = before


def stepping() -> bool:
    """Whether a step body is being warmed up or captured: its collectives
    through the host are then host calls (:func:`host_call`) on buffers of
    the step's own (:func:`host_buffer`)."""
    return _RUN is not None


def host_call(fn: Callable[[], None]) -> None:
    """``fn()`` on the host at this point of a step: at once outside a
    capture; in one, a cut (module doc), and ``fn`` runs between the two
    graphs at every replay."""
    run = _RUN
    if run is None:
        fn()
        return
    run.calls += 1
    if run.cut is None:
        with profiling.span("gvqa.step.host_call"):
            fn()
    else:
        run.cut(fn)


def host_buffer(like: torch.Tensor) -> torch.Tensor:
    """The step's own tensor for its next host call, filled with ``like``
    (inside a warm-up or capture, :func:`stepping`): the warm-up makes one
    per call, outside the graphs' pool, and the capture takes them again
    in the same order (module doc)."""
    run = _RUN
    if run.at == len(run.buffers):
        if run.cut is not None:
            raise RuntimeError(
                "a host call's buffer first asked for inside a capture: the "
                "body reached a host call that its warm-up did not")
        run.buffers.append(torch.empty_like(like))
    buf = run.buffers[run.at]
    if buf.shape != like.shape or buf.dtype != like.dtype:
        raise RuntimeError(
            f"host call {run.at} takes {tuple(like.shape)} {like.dtype}, its "
            f"warm-up took {tuple(buf.shape)} {buf.dtype}")
    run.at += 1
    return buf.copy_(like)


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


@dataclasses.dataclass
class _Graph:
    """One key's graphs: its static batch, the replay of its chain, and its
    host calls' buffers and count (from the warm-up)."""
    static: Any = None
    replay: Optional[Callable] = None
    buffers: list = dataclasses.field(default_factory=list)
    host_calls: int = 0


class StepGraphs:
    """One graph, or one chain of graphs cut at the host calls, per batch
    key for a step body (module doc). ``capture_fn(fn, generators, device,
    mode)`` turns a body into a replay (:func:`cuda_graph_capture`; tests
    pass their own). ``warm_ups``, ``captures``, ``replays`` count the
    calls of each kind, ``capture_seconds`` holds each key's capture time
    on the host clock and ``segments`` each key's graphs (its host calls +
    1). Each call is the span ``gvqa.step``, around its warm-up, capture,
    copy of the batch into the static tensors and replay
    (``core/profiling.py``); the graphs are dropped when tracing is turned
    on or off, so that none replays with stale instrumentation."""

    def __init__(self, capture_fn: Optional[Callable] = None):
        self.capture_fn = capture_fn or cuda_graph_capture
        self.graphs: Dict[tuple, _Graph] = {}
        self.bound: tuple = ()
        self.traced = profiling.enabled()
        self.warm_ups = self.captures = self.replays = 0
        self.capture_seconds: Dict[tuple, float] = {}
        self.segments: Dict[tuple, int] = {}

    def __call__(self, body, batch,
                 generators: Sequence[Optional[torch.Generator]] = (),
                 bind: Sequence[Any] = ()):
        """``body(batch)`` through the key's graphs -> its outputs (the
        graphs' own tensors on a replay: module doc).
        ``bind``: the objects whose tensors the body reads (the train
        state); ``generators``: those it draws from (None entries skipped)."""
        with profiling.span("gvqa.step"):
            return self._call(body, batch, generators, bind)

    def _call(self, body, batch, generators, bind):
        generators = tuple(g for g in generators if g is not None)
        bound = tuple(bind) + generators
        traced = profiling.enabled()
        if traced != self.traced or len(bound) != len(self.bound) or any(
                a is not b for a, b in zip(bound, self.bound)):
            self.graphs.clear()
            self.capture_seconds.clear()
            self.segments.clear()
            self.bound, self.traced = bound, traced
        key = batch_key(batch)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = _Graph()
            self.warm_ups += 1
            with profiling.span("gvqa.step.warm_up"):
                return self._warm_up(entry, body, batch)
        if entry.replay is None:
            with profiling.span("gvqa.step.capture"):
                self._capture(entry, key, body, batch, generators)
        else:
            with profiling.span("gvqa.step.copy_in"):
                for dst, src in zip(_tensors(entry.static), _tensors(batch)):
                    dst.copy_(src)
        with profiling.span("gvqa.step.replay"):
            out = entry.replay()
        self.replays += 1
        return out

    def _warm_up(self, entry, body, batch):
        device = batch.questions.device
        with _running(_Run(entry.buffers)) as run:
            if device.type != "cuda":
                out = body(batch)
            else:
                stream = _side_stream(device)
                current = torch.cuda.current_stream()
                stream.wait_stream(current)
                with torch.cuda.stream(stream):
                    out = body(batch)
                current.wait_stream(stream)
        entry.host_calls = run.calls
        return out

    def _capture(self, entry, key, body, batch, generators):
        entry.static = map_tensors(torch.clone, batch)
        cuts = []

        def run(cut):
            with _running(_Run(entry.buffers, cut)) as r:
                out = body(entry.static)
            cuts.append(r.calls)
            return out

        t0 = time.perf_counter()
        entry.replay = self.capture_fn(
            run, generators, batch.questions.device,
            "relaxed" if entry.host_calls else "thread_local")
        if cuts[0] != entry.host_calls:
            raise RuntimeError(
                f"the capture reached {cuts[0]} host calls, its warm-up "
                f"{entry.host_calls}: the body is not the same program")
        self.capture_seconds[key] = time.perf_counter() - t0
        self.segments[key] = entry.host_calls + 1
        self.captures += 1
