"""Constant tables on a device, copied once.

A host array copied to the card with a plain `.to(device)` goes through
pageable memory, and PyTorch waits for that copy to end: a host sync on
every call that rebuilds it. The frame step's tables (ORB's disc masks and
BRIEF pattern, solver schedules) are made once per device and key here.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import numpy as np
import torch

_CACHE: Dict[Tuple[Hashable, str, torch.dtype], torch.Tensor] = {}


def device_constant(key: Hashable, make: Callable[[], np.ndarray], device,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """make() as a `dtype` tensor on `device`, built and copied at the first
    call for (key, device, dtype) and reused after; never write to it."""
    k = (key, str(torch.device(device)), dtype)
    out = _CACHE.get(k)
    if out is None:
        out = torch.from_numpy(np.ascontiguousarray(make())).to(device,
                                                                dtype)
        _CACHE[k] = out
    return out


def upload(x, device) -> torch.Tensor:
    """A host array or tensor on `device` without waiting for the copy: to
    a CUDA device through pinned memory with non_blocking (the pinned block
    is held until the copy ends); tensors already there pass through."""
    t = torch.as_tensor(x)
    dev = torch.device(device)
    if t.device == dev or (dev.type == t.device.type
                           and dev.index is None):
        return t
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
