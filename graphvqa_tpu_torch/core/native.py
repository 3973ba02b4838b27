"""ctypes binding of the native C++ batch packer (``native/packing.cc``).

Port of ``graphvqa_tpu/core/native.py``: ``pack_graphs_native`` and
``pack_graphs_dense_native`` are byte-for-byte the numpy packers of
``core/packing.py`` (the flat and the dense layout), in C++.

The library is built at first use with ``g++`` from ``native/packing.cc``
into ``build/graphvqa_tpu_torch/`` (never into ``native/``, which the JAX
package builds with ``make``). The Makefile's flags include
``-march=native``, so the file name carries a hash of the source, the flags
and the host (its name and what ``-march=native`` means to the compiler
there): a library built on another machine is never loaded. The build goes
to a per-process temporary file, renamed into place, so processes that build
at once do not load a half-written file.

Without a compiler the packers fall back to the numpy ones and log so once;
``packer_name()`` says which one is in use.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import platform
import subprocess
from typing import Optional, Sequence

import numpy as np
import torch

from graphvqa_tpu_torch.core.graph import GraphBatch
from graphvqa_tpu_torch.core.packing import (
    GraphSample, pack_graphs, pack_graphs_dense)

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "native" / "packing.cc"
_BUILD_DIR = _REPO / "build" / "graphvqa_tpu_torch"
_CXX = os.environ.get("CXX", "g++")
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
# gp_pack / gp_pack_dense: sizes, offsets and inputs, the bucket, outputs
_PACK_ARGS = ([ctypes.c_int32] * 4 + [_i32p] * 2 + [_i32p] * 4 + [_u8p, _f32p]
              + [ctypes.c_int32] * 2 + [_i32p, _i32p, _u8p, _i32p, _i32p,
                                        _i32p, _u8p, _f32p, _f32p])


class _State:
    lib: Optional[ctypes.CDLL] = None
    tried = False
    path: Optional[pathlib.Path] = None


def _host_key() -> bytes:
    """The host's name and the compiler's expansion of -march=native."""
    try:
        probe = subprocess.run(
            [_CXX, "-march=native", "-E", "-v", "-x", "c++", os.devnull],
            capture_output=True, text=True, timeout=60)
        march = [line for line in probe.stderr.splitlines()
                 if "-march=" in line and "cc1" in line]
    except (OSError, subprocess.SubprocessError):
        march = []
    return "\n".join([platform.node(), platform.machine(), *march]).encode()


def _library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()
                            + _host_key()).hexdigest()[:16]
    return _BUILD_DIR / f"libgraphpack_{digest}.so"


def _load() -> Optional[ctypes.CDLL]:
    if _State.tried:
        return _State.lib
    _State.tried = True
    try:
        so = _library_path()
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([_CXX, *_FLAGS, "-o", str(tmp), str(_SOURCE)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as exc:
        logging.warning("collate packer: numpy (the native packer did not "
                        "build or load: %s)", exc)
        return None
    for fn in (lib.gp_pack, lib.gp_pack_dense):
        fn.restype = ctypes.c_int
    lib.gp_pack.argtypes = _PACK_ARGS
    lib.gp_pack_dense.argtypes = [ctypes.c_int32] + _PACK_ARGS
    _State.lib, _State.path = lib, so
    logging.info("collate packer: native (%s)", so)
    return lib


def native_available() -> bool:
    return _load() is not None


def packer_name() -> str:
    """'native' (with the library's path) or 'numpy': the packer in use."""
    return f"native ({_State.path})" if _load() is not None else "numpy"


def _ptr(a: Optional[np.ndarray], ty):
    return None if a is None else a.ctypes.data_as(ty)


def _ragged_inputs(samples: Sequence[GraphSample], max_steps: int):
    """Offsets and the concatenated ragged arrays of ``samples``."""
    n = len(samples)
    node_off = np.zeros(n + 1, np.int32)
    edge_off = np.zeros(n + 1, np.int32)
    for g, s in enumerate(samples):
        node_off[g + 1] = node_off[g] + s.num_nodes
        edge_off[g + 1] = edge_off[g] + s.num_edges

    def cat(arrays, dtype):
        return np.ascontiguousarray(np.concatenate(arrays), dtype)

    inputs = [cat([s.node_tokens for s in samples], np.int32),
              cat([s.edge_src for s in samples], np.int32),
              cat([s.edge_dst for s in samples], np.int32),
              cat([s.edge_tokens for s in samples], np.int32),
              cat([s.edge_sym for s in samples], np.uint8)]
    bitmap = None
    if all(s.exec_bitmap is not None for s in samples):
        def pad_steps(b):
            k = min(max_steps, b.shape[1])
            out = np.zeros((b.shape[0], max_steps), np.float32)
            out[:, :k] = b[:, :k]
            return out
        bitmap = cat([pad_steps(s.exec_bitmap) for s in samples], np.float32)
    return node_off, edge_off, inputs, bitmap


def _outputs(nodes_pad, edges_pad, tok_w, etok_w, max_steps):
    return dict(
        node_tokens=np.empty((nodes_pad, tok_w), np.int32),
        node_graph=np.empty((nodes_pad,), np.int32),
        node_mask=np.empty((nodes_pad,), np.uint8),
        edge_src=np.empty((edges_pad,), np.int32),
        edge_dst=np.empty((edges_pad,), np.int32),
        edge_tokens=np.empty((edges_pad, etok_w), np.int32),
        edge_mask=np.empty((edges_pad,), np.uint8),
        edge_sym_sign=np.empty((edges_pad,), np.float32),
        exec_bitmap=np.empty((nodes_pad, max_steps), np.float32))


def _call(fn, head, samples, nodes_pad, edges_pad, tail, max_steps, **shape):
    """Run ``gp_pack`` or ``gp_pack_dense`` -> GraphBatch of CPU tensors."""
    tok_w = samples[0].node_tokens.shape[1]
    etok_w = samples[0].edge_tokens.shape[1]
    node_off, edge_off, (nt, es, ed, et, sym), bm = _ragged_inputs(
        samples, max_steps)
    out = _outputs(nodes_pad, edges_pad, tok_w, etok_w, max_steps)
    tys = (_i32p, _i32p, _u8p, _i32p, _i32p, _i32p, _u8p, _f32p, _f32p)
    ret = fn(*head, tok_w, etok_w, max_steps,
             _ptr(node_off, _i32p), _ptr(edge_off, _i32p),
             _ptr(nt, _i32p), _ptr(es, _i32p), _ptr(ed, _i32p),
             _ptr(et, _i32p), _ptr(sym, _u8p), _ptr(bm, _f32p), *tail,
             *(_ptr(a, ty) for a, ty in zip(out.values(), tys)))
    if ret != 0:
        raise ValueError(f"{fn.__name__} overflow ({ret})")
    out["node_mask"] = out["node_mask"].astype(bool)
    out["edge_mask"] = out["edge_mask"].astype(bool)
    return GraphBatch(**{k: torch.from_numpy(v) for k, v in out.items()},
                      **shape)


def pack_graphs_native(samples: Sequence[GraphSample], nodes_pad: int,
                       edges_pad: int, max_steps: int = 5) -> GraphBatch:
    """Native ``pack_graphs`` (the flat layout, always dst-sorted)."""
    lib = _load()
    if lib is None or not samples:
        return pack_graphs(samples, nodes_pad, edges_pad, max_steps)
    total_nodes = sum(s.num_nodes for s in samples)
    total_edges = sum(s.num_edges for s in samples)
    if total_nodes > nodes_pad or total_edges > edges_pad:
        raise ValueError(
            f"batch ({total_nodes}n/{total_edges}e) overflows bucket "
            f"({nodes_pad}/{edges_pad})")
    return _call(lib.gp_pack, (len(samples),), samples, nodes_pad, edges_pad,
                 (nodes_pad, edges_pad), max_steps, num_graphs=len(samples))


def pack_graphs_dense_native(samples: Sequence[GraphSample],
                             nodes_per_graph: int, edges_per_graph: int,
                             max_steps: int = 5,
                             num_graphs: Optional[int] = None) -> GraphBatch:
    """Native ``pack_graphs_dense`` (the dense layout)."""
    lib = _load()
    if lib is None or not samples:
        return pack_graphs_dense(samples, nodes_per_graph, edges_per_graph,
                                 max_steps, num_graphs)
    B = num_graphs if num_graphs is not None else len(samples)
    if len(samples) > B:
        raise ValueError(f"{len(samples)} samples > num_graphs={B}")
    npg, epg = nodes_per_graph, edges_per_graph
    return _call(lib.gp_pack_dense, (len(samples), B), samples, B * npg,
                 B * epg, (npg, epg), max_steps, num_graphs=B,
                 nodes_per_graph=npg, edges_per_graph=epg)
