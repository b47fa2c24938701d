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

from geoflowslam_tpu_torch.utils import sync_audit

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


def stage(x: np.ndarray, device, dtype: torch.dtype = None) -> torch.Tensor:
    """A host array as a tensor (of `dtype`) on `device` without a host
    sync: to a CUDA device from pinned memory with non_blocking (the pinned
    block is held until the copy ends), on the CPU the array itself."""
    dev = torch.device(device)
    with sync_audit.host_staging():
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t if t.device == dev else t.to(dev)


def upload(x, device) -> torch.Tensor:
    """A host array or tensor on `device` without waiting for the copy: to
    a CUDA device through pinned memory with non_blocking (the pinned block
    is held until the copy ends); tensors already there pass through."""
    if isinstance(x, np.ndarray):
        return stage(x, device)
    t = torch.as_tensor(x)
    dev = torch.device(device)
    if t.device == dev or (dev.type == t.device.type
                           and dev.index is None):
        return t
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class HostCopy:
    """A device tensor's copy to the host, started without a wait: on a
    CUDA device into pinned memory with non_blocking, an event recorded
    after it on the tensor's stream; `get()` (or np.asarray) waits for the
    event, which a copy started frames earlier has long passed, and returns
    the numpy array. On the CPU it holds a copy of the tensor."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.device(t.device):
                self._host.copy_(t, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t.detach().clone()
        self._np = None

    def get(self) -> np.ndarray:
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()
            self._np = self._host.numpy()
        return self._np

    def __array__(self, dtype=None, copy=None):
        a = self.get()
        return a if dtype is None else a.astype(dtype)
