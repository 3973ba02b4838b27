"""The fused GAT round: a hand-written CUDA kernel and its plain twin.

``gat_round`` computes the forward contract of the JAX package's
``ops/dense.py:dense_gat_aggregate`` on the dense layout (whose TPU kernel is
``ops/pallas/fused_dense_gat.py:pallas_fused_dense_gat``): per-edge logits
``leaky_relu(al[src] + ar[dst] + ae)``, the destination softmax with the
'graph' or 'dst' shift, the attention-weighted sum of ``xw[src]`` per
destination, the head mean, and the per-graph ``ins_value`` share through the
attention row sums.

On a CUDA tensor the wrapper launches ``csrc/gat_round.cu`` (built with nvcc
for sm_90a at first use, bound with ctypes) or raises; on a CPU tensor it
runs :func:`gat_round_reference`, the same math in index ops. The kernel
takes any 2-byte aligned ``xw`` and ``out``: it copies a graph's rows with
one bulk copy where they are 16-byte aligned and in smaller pieces where
not. Its blocks take graphs from a counter, a 4-byte tensor that the
wrapper allocates per call and the library zeroes on the stream before each
launch.

The wrapper takes each graph's edges as the dense packing lays them out
(``core/packing.py:pack_graphs_dense``): the real edges first, sorted by
destination, the padded ones last. On the CPU it raises on any other order;
on the card the kernel's device assert stops it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Optional

import torch

from graphvqa_tpu_torch.ops.dense import NEG_INF, SOFTMAX_EPS

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "gat_round.cu"
_BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2]
              / "build" / "graphvqa_tpu_torch")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHIFTS = ("graph", "dst")


class KernelLibrary:
    """The built shared library, its build log and the build's wall time."""

    def __init__(self, path: pathlib.Path, log: str, build_seconds: float):
        self.path, self.log, self.build_seconds = path, log, build_seconds
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gat_round_launch.argtypes = (
            [ci] + [vp] * 10 + [ci] * 5 + [ctypes.c_float, ci, vp])
        lib.gat_round_launch.restype = ci
        lib.gat_round_smem_bytes.argtypes = [ci] * 5
        lib.gat_round_smem_bytes.restype = ctypes.c_size_t
        self.lib = lib


_library: Optional[KernelLibrary] = None
# per device index: the shared memory a block may opt into; per (npg, epg,
# H, C, dtype): the least the kernel needs. Both fixed for a process.
_smem_limit: dict = {}
_smem_need: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{_SRC.name}")


def load_library() -> KernelLibrary:
    """Build ``csrc/gat_round.cu`` into ``build/graphvqa_tpu_torch/`` (once
    per source content) and load it."""
    global _library
    if _library is not None:
        return _library
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libgat_round_{digest}.so"
    log, seconds = "cached build", 0.0
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    _library = KernelLibrary(out, log, seconds)
    return _library


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _real_edges(dl, sl, mask, npg):
    """[B, epg] bool: mask > 0 and both local indices inside [0, npg)."""
    return ((mask > 0) & (dl >= 0) & (dl < npg) & (sl >= 0) & (sl < npg))


def edges_dst_sorted(dl, sl, mask, npg) -> bool:
    """True when every graph's real edges come first, sorted by destination,
    and its padded edges last (the kernel's precondition)."""
    real = _real_edges(dl, sl, mask, npg)
    d = torch.where(real, dl, -1)
    prev = d[:, :-1]
    return not bool((real[:, 1:] & ((prev < 0) | (prev > d[:, 1:]))).any())


def gat_round_reference(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
                        ins_value=None, *, npg, epg, negative_slope=0.2,
                        shift="graph"):
    """Plain torch twin of the kernel (same arguments, same math).

    dl/sl [B, epg] local indices, mask [B, epg] (>0 = real edge), alpha_l /
    alpha_r [B*npg, H] f32, alpha_e [B, epg, H], xw [B*npg, H, C],
    ins_value [B, H, C] or None -> [B*npg, C] in xw's dtype, accumulated in
    float32.
    """
    if shift not in _SHIFTS:
        raise ValueError(f"unknown softmax shift {shift!r}")
    B = dl.shape[0]
    N, H, C = xw.shape
    dev = xw.device
    base = (torch.arange(B, device=dev) * npg)[:, None]
    dl64, sl64 = dl.long(), sl.long()
    real = _real_edges(dl64, sl64, mask, npg).reshape(-1)
    dst = torch.where(real, (dl64 + base).reshape(-1), 0)
    src = torch.where(real, (sl64 + base).reshape(-1), 0)
    lg = (alpha_l.float().index_select(0, src)
          + alpha_r.float().index_select(0, dst)) \
        + alpha_e.float().reshape(B * epg, H)
    lg = torch.where(lg >= 0, lg, negative_slope * lg)
    lg = torch.where(real[:, None], lg, NEG_INF)
    if shift == "graph":
        gmax = lg.reshape(B, epg, H).amax(dim=1).clamp(min=NEG_INF)
        shift_e = gmax.repeat_interleave(epg, dim=0)
    else:
        dmax = torch.full((N, H), NEG_INF, device=dev).scatter_reduce(
            0, dst[:, None].expand(-1, H), lg, reduce="amax")
        shift_e = dmax.index_select(0, dst)
    p = torch.where(real[:, None], torch.exp((lg - shift_e).clamp(max=0.0)),
                    0.0)
    denom = torch.zeros(N, H, device=dev).index_add_(0, dst, p)
    recip = (1.0 / H) / (denom + SOFTMAX_EPS)
    a = p * recip.index_select(0, dst)                           # [E, H]
    msgs = torch.einsum("eh,ehc->ec", a, xw.float().index_select(0, src))
    out = torch.zeros(N, C, device=dev).index_add_(0, dst, msgs)
    if ins_value is not None:
        rowsum = torch.zeros(N, H, device=dev).index_add_(0, dst, a)
        out = out + torch.einsum("bnh,bhc->bnc", rowsum.reshape(B, npg, H),
                                 ins_value.float()).reshape(N, C)
    return out.to(xw.dtype)


def gat_round(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw, ins_value=None,
              *, npg, epg, negative_slope=0.2, shift="graph"):
    """One fused GAT round -> [B*npg, C] in xw's dtype (see module doc).

    CUDA tensors launch the kernel (and count the launch in
    ``gat_round.launches``); CPU tensors run :func:`gat_round_reference`.
    ``alpha_e`` is cast to float32 here; ``ins_value`` must share xw's dtype.
    Edges must be in the dense packing's order (module doc).
    """
    if xw.device.type == "cpu":
        if not edges_dst_sorted(dl, sl, mask, npg):
            raise ValueError("gat_round needs each graph's real edges first "
                             "and sorted by destination, padding last")
        return gat_round_reference(
            dl, sl, mask, alpha_l, alpha_r, alpha_e, xw, ins_value, npg=npg,
            epg=epg, negative_slope=negative_slope, shift=shift)
    if xw.device.type != "cuda":
        raise ValueError(f"gat_round runs on cuda or cpu, not {xw.device}")
    if shift not in _SHIFTS:
        raise ValueError(f"unknown softmax shift {shift!r}")
    if xw.ndim != 3:
        raise ValueError(f"xw must be [B*npg, H, C], got {tuple(xw.shape)}")
    B = dl.shape[0]
    N, H, C = xw.shape
    dev = xw.device
    alpha_e = alpha_e.float().contiguous()
    _check("xw", xw, (B * npg, H, C), tuple(_DTYPES), dev)
    _check("dl", dl, (B, epg), (torch.int32,), dev)
    _check("sl", sl, (B, epg), (torch.int32,), dev)
    _check("mask", mask, (B, epg), (torch.float32,), dev)
    _check("alpha_l", alpha_l, (N, H), (torch.float32,), dev)
    _check("alpha_r", alpha_r, (N, H), (torch.float32,), dev)
    _check("alpha_e", alpha_e, (B, epg, H), (torch.float32,), dev)
    if ins_value is not None:
        _check("ins_value", ins_value, (B, H, C), (xw.dtype,), dev)
    lib = _library or load_library()
    code = _DTYPES[xw.dtype]
    need = _smem_need.get((npg, epg, H, C, code))
    if need is None:
        need = _smem_need[(npg, epg, H, C, code)] = (
            lib.lib.gat_round_smem_bytes(npg, epg, H, C, code))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    limit = _smem_limit.get(index)
    if limit is None:
        limit = _smem_limit[index] = getattr(
            torch.cuda.get_device_properties(index),
            "shared_memory_per_block_optin", 232448)
    if need > limit:
        raise ValueError(f"npg={npg}, epg={epg}, H={H}, C={C} needs {need} B "
                         f"of shared memory per block; the card allows "
                         f"{limit}")
    out = torch.empty((N, C), dtype=xw.dtype, device=dev)
    # the kernel's graph counter, which the library zeroes on the stream
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    args = (code, dl.data_ptr(), sl.data_ptr(), mask.data_ptr(),
            alpha_l.data_ptr(), alpha_r.data_ptr(), alpha_e.data_ptr(),
            xw.data_ptr(), None if ins_value is None else ins_value.data_ptr(),
            out.data_ptr(), counter.data_ptr(), B, npg, epg, H, C,
            float(negative_slope), int(shift == "graph"))
    stream = torch.cuda.current_stream(index).cuda_stream
    # the library launches on the current device: switch only when needed
    if torch.cuda.current_device() == index:
        err = lib.lib.gat_round_launch(*args, stream)
    else:
        with torch.cuda.device(index):
            err = lib.lib.gat_round_launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"gat_round kernel launch failed: CUDA error {err}")
    gat_round.launches += 1
    return out


gat_round.launches = 0
