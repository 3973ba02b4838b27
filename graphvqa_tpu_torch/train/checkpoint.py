"""Checkpoint save and restore with a tolerant partial load (port of
``graphvqa_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file per epoch, ``ckpt_<epoch>.pt`` in a
directory, holding {params, batch_stats, opt_state, step, epoch}; the last
``keep`` stay. A partial restore keeps every saved entry whose name and
shape match the current model and logs the rest, as the reference's
tolerant loader does.
"""
from __future__ import annotations

import logging
import os
import pathlib
import re
from typing import Any, Optional, Tuple

import torch

from graphvqa_tpu_torch.train.train_state import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


def _epochs(path: pathlib.Path):
    return sorted(int(m.group(1)) for f in path.glob("ckpt_*.pt")
                  if (m := _NAME.search(f.name)))


def save_checkpoint(path, state: TrainState, keep: int = 3) -> None:
    path = pathlib.Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    payload = {"params": {k: v.detach() for k, v in state.params.items()},
               "batch_stats": state.batch_stats,
               "opt_state": state.opt_state,
               "step": int(state.step), "epoch": int(state.epoch)}
    target = path / f"ckpt_{int(state.epoch)}.pt"
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, target)
    for epoch in _epochs(path)[:-keep]:
        (path / f"ckpt_{epoch}.pt").unlink()


def _partial_merge(current: Any, saved: Any, prefix: str = "") -> Any:
    """Keep saved entries whose structure and shape match; log the rest."""
    if isinstance(current, dict) and isinstance(saved, dict):
        out = {}
        for k, v in current.items():
            if k in saved:
                out[k] = _partial_merge(v, saved[k], f"{prefix}/{k}")
            else:
                logging.info("checkpoint: missing key %s/%s — keeping init",
                             prefix, k)
                out[k] = v
        return out
    if (isinstance(saved, torch.Tensor) and isinstance(current, torch.Tensor)
            and saved.shape == current.shape):
        return saved
    logging.info("checkpoint: shape mismatch at %s (%s vs %s) — keeping init",
                 prefix, getattr(saved, "shape", None),
                 getattr(current, "shape", None))
    return current


def restore_checkpoint(path, state: TrainState, step: Optional[int] = None,
                       strict: bool = False) -> Tuple[TrainState, int]:
    """Restore the latest checkpoint (or epoch ``step``) into ``state`` in
    place; returns (state, start_epoch)."""
    path = pathlib.Path(path).absolute()
    epochs = _epochs(path)
    if step is None:
        if not epochs:
            raise FileNotFoundError(f"no checkpoint under {path}")
        step = epochs[-1]
    device = next(state.model.parameters()).device
    saved = torch.load(path / f"ckpt_{step}.pt", map_location=device,
                       weights_only=True)
    params, stats = saved["params"], saved["batch_stats"]
    if not strict:
        params = _partial_merge(state.params, params)
        stats = _partial_merge(state.batch_stats, stats)
    state.model.load_state_dict({**params, **stats}, strict=strict)
    state.opt_state = saved["opt_state"]
    state.step, state.epoch = saved["step"], saved["epoch"]
    return state, int(saved["epoch"]) + 1  # training resumes after it
