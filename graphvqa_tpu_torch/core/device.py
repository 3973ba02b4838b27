"""Device selection for the port's entry points.

Entry points take ``device=None`` and mean the GPU by it. Without a GPU they
raise: the port never drops to the CPU on its own. Tests and CPU runs pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when the device asked for is a GPU and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
