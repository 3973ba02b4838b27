"""The one seam of the port's hand-written CUDA kernels: their build, their
binding, their contract checks, their launch on the current stream and the
launch counts they keep on the card. An op module holds only its kernel's
contract, its plain twin and its autograd ``Function``.

Each ``csrc/*.cu`` source builds with nvcc for sm_90a into a shared library
of its own under ``build/graphvqa_tpu_torch/``, cached by the content of
the source and of the ``csrc/`` headers it includes and by the flags.
:func:`kernel_libraries` builds the model's kernel sources
(:data:`KERNEL_SOURCES`) at their first use, one nvcc each, all started
together, so a first step waits for the slowest build, not for their sum; a
source outside them (the tracing's ``segment_stamp.cu``) builds alone, at
its first :func:`bind`. :func:`bind` loads a library with ctypes and sets
each launcher's signature, once per process.

:func:`check_tensor` and :data:`DTYPE_CODES` are the kernels' shared input
contract. :func:`launch` calls a launcher with the current stream of a
tensor's card. Each kernel counts its own launches where it runs: block 0
adds one to a 64-bit word of its kind (:data:`KINDS`) on its card
(:func:`launch_word`), so a CUDA graph's replay, which runs no Python,
counts its launches as eager calls do (:func:`launch_counts`,
:func:`reset_launch_counts`). A new kernel adds its source to
:data:`KERNEL_SOURCES` and its kinds to :data:`KINDS`; every reader of the
counts takes them by name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
# the kernels the model runs, by name (a library each, built together)
KERNEL_SOURCES = {name: CSRC / f"{name}.cu"
                  for name in ("gat_round", "gat_round_backward",
                               "layer_norm", "gine_messages",
                               "gine_messages_backward", "lcgn_linear",
                               "lcgn_linear_backward")}
# the kinds of launch the kernels count on the card, in the order the CLI
# prints them
KINDS = ("gat_round", "gat_round_backward", "layer_norm",
         "layer_norm_backward", "gine_messages", "gine_messages_backward",
         "lcgn_rows", "lcgn_linear", "lcgn_linear_backward")
# the kernels' code for each float dtype they take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2]
              / "build" / "graphvqa_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# cudaErrorStreamCaptureUnsupported: the libraries' answer to a launch that
# would set a kernel attribute while its stream is capturing
_CAPTURE_UNSUPPORTED = 900


class Built(NamedTuple):
    """Built libraries: {name: path}, the build log, the build's wall
    seconds (0 where every library was cached)."""
    paths: dict
    log: str
    build_seconds: float


_built: Optional[Built] = None
# per source name: its library, bound
_bound: Dict[str, ctypes.CDLL] = {}
# per (kind, device index): the int64 word on that card to which each
# launch of the kind adds one
_launch_words: dict = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels (csrc/)")


def _source_bytes(src: pathlib.Path) -> bytes:
    """The source's bytes and those of each header it includes by a quoted
    name from its own directory."""
    text = src.read_bytes()
    for name in re.findall(rb'#include "([^"]+)"', text):
        text += (src.parent / name.decode()).read_bytes()
    return text


def build_sources(sources: dict) -> Built:
    """nvcc on each ``{name: source}`` into a shared library of its own
    under ``build/graphvqa_tpu_torch/`` (cached by the content of the source
    and its headers and by the flags; the builds run in parallel)."""
    paths, jobs, logs = {}, {}, []
    t0 = time.perf_counter()
    for key, src in sources.items():
        digest = hashlib.sha256(_source_bytes(src) + " ".join(
            NVCC_FLAGS).encode()).hexdigest()[:16]
        out = paths[key] = _BUILD_DIR / f"lib{src.stem}_{digest}.so"
        if out.exists():
            logs.append(f"{src.name}: cached build")
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     tmp, out, src)
    failed = []
    for proc, tmp, out, src in jobs.values():
        text, _ = proc.communicate()
        logs.append(f"{src.name}:\n{text}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):"
                          f"\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return Built(paths, "\n".join(logs),
                 time.perf_counter() - t0 if jobs else 0.0)


def kernel_libraries() -> Built:
    """:data:`KERNEL_SOURCES` built (on the first call; module doc)."""
    global _built
    if _built is None:
        _built = build_sources(KERNEL_SOURCES)
    return _built


def bind(name: str,
         signatures: Dict[str, Tuple[Sequence, type]]) -> ctypes.CDLL:
    """The library of source ``name`` with each launcher's ``{function:
    (argtypes, restype)}`` set; built and bound on the first call (module
    doc), the same object after."""
    lib = _bound.get(name)
    if lib is None:
        paths = (kernel_libraries() if name in KERNEL_SOURCES
                 else build_sources({name: CSRC / f"{name}.cu"})).paths
        lib = ctypes.CDLL(str(paths[name]))
        for fn, (argtypes, restype) in signatures.items():
            launcher = getattr(lib, fn)
            launcher.argtypes, launcher.restype = list(argtypes), restype
        _bound[name] = lib
    return lib


def check_tensor(name: str, t: torch.Tensor, shape, dtypes,
                 device: torch.device) -> None:
    """Raise unless ``t`` is on ``device``, of one of ``dtypes``, of
    ``shape`` and contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def on_device(dev: torch.device, fn, *args):
    """``fn(*args)`` with ``dev``'s card current (switched only when
    needed): the libraries launch on, and ask about, the current device."""
    index = device_index(dev)
    if torch.cuda.current_device() == index:
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


def launch(fn, args, dev, what):
    """Call a library launcher with the current stream of ``dev``'s card
    last; raise on the CUDA error it returns."""
    stream = torch.cuda.current_stream(device_index(dev)).cuda_stream
    err = on_device(dev, fn, *args, stream)
    if err == _CAPTURE_UNSUPPORTED:
        raise RuntimeError(
            f"{what} met new widths inside a CUDA graph capture: the kernel "
            f"sets its shared-memory attribute on an eager launch, so run "
            f"the step once eagerly at this batch shape before capturing it")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def launch_word(kind: str, dev: torch.device) -> torch.Tensor:
    """``kind``'s launch count on ``dev``'s card, made on its first eager
    launch there (one made in a capture would lie in the graph's pool)."""
    key = (kind, device_index(dev))
    word = _launch_words.get(key)
    if word is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{kind} launches on {dev} for the first time inside a CUDA "
                f"graph capture: run the step once eagerly before capturing")
        # a normal tensor even when the first launch is an eval step's,
        # so that reset_launch_counts may zero it anywhere
        with torch.inference_mode(False):
            word = _launch_words[key] = torch.zeros(1, dtype=torch.int64,
                                                    device=dev)
    return word


def launch_counts() -> Dict[str, int]:
    """{kind: launches} for every kind of :data:`KINDS`, in that order, on
    every card since the last :func:`reset_launch_counts`, as the kernels
    counted them where they ran: eager launches and those of CUDA graph
    replays alike. Reads the cards, so it waits for the work queued on them;
    0 for a kind that never launched (on the CPU the plain twins run)."""
    counts = dict.fromkeys(KINDS, 0)
    for (kind, _), word in _launch_words.items():
        counts[kind] += int(word.item())
    return counts


def reset_launch_counts() -> None:
    """Set every kernel's launch counts on every card to 0 (on the current
    stream)."""
    for word in _launch_words.values():
        word.zero_()
