"""A dispatch audit of the operations that synchronise with the host on CUDA.

On the CPU nothing waits, so a read of the device that would stall the card
(a scalar read, `nonzero`, a boolean mask, `eigh`/`svd`, a tensor built
from host data through pageable memory) is invisible there. `audit()`
counts them as they are dispatched, on any device:

    with audit() as hits:
        fn()
    assert hits == [], hits

With `sites=True` each hit is (name, "file:line" of the innermost frame of
this package that made it), for finding where a read comes from.

The one exemption is `host_staging()`: utils/device_const.stage builds a
host array into a tensor and copies it to a CUDA device from pinned memory
with non_blocking, which does not wait; on the CPU it only wraps the array.
"""
from __future__ import annotations

import contextlib
import os
import threading
import traceback

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

SYNC_ATEN = {"_local_scalar_dense", "nonzero", "unique", "_unique",
             "_unique2", "unique_dim", "unique_consecutive", "masked_select",
             "_linalg_eigh", "linalg_eigh", "linalg_eigvalsh",
             "_linalg_svd", "linalg_inv", "linalg_solve", "linalg_cholesky",
             "repeat_interleave", "bincount", "histc", "lift_fresh",
             "lift_fresh_copy", "equal", "is_nonzero", "masked_scatter"}
SYNC_METHODS = {"item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                "__float__", "__index__", "tensor", "as_tensor"}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STAGING = threading.local()


@contextlib.contextmanager
def host_staging():
    """The block's operations are not counted (see the module doc)."""
    _STAGING.depth = getattr(_STAGING, "depth", 0) + 1
    try:
        yield
    finally:
        _STAGING.depth -= 1


def _staging() -> bool:
    return getattr(_STAGING, "depth", 0) > 0


def _site() -> str:
    """file:line of the innermost caller inside this package (not this
    module), else of the innermost caller outside torch."""
    here = os.path.abspath(__file__)
    frames = [f for f in traceback.extract_stack()
              if os.path.abspath(f.filename) != here]
    for f in reversed(frames):
        if os.path.abspath(f.filename).startswith(_PKG):
            path = os.path.relpath(os.path.abspath(f.filename),
                                   os.path.dirname(_PKG))
            return f"{path}:{f.lineno}"
    f = next((f for f in reversed(frames)
              if os.sep + "torch" + os.sep not in f.filename), frames[-1])
    return f"{f.filename}:{f.lineno}"


class Audit(TorchDispatchMode):
    """Counts the ATen operations that synchronise with the host on CUDA."""

    def __init__(self, hits, sites: bool = False):
        super().__init__()
        self.hits = hits
        self.sites = sites

    def _hit(self, name):
        self.hits.append((name, _site()) if self.sites else name)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        if _staging():
            return func(*args, **(kwargs or {}))
        if name in SYNC_ATEN:
            self._hit(name)
        if name in ("index", "index_put", "index_put_"):
            if any(i is not None and i.dtype == torch.bool for i in args[1]):
                self._hit(name + " (bool mask)")
        return func(*args, **(kwargs or {}))


class AuditPy(TorchFunctionMode):
    """Counts the Python-level calls that read a tensor on the host or
    build one from host data."""

    def __init__(self, hits, sites: bool = False):
        super().__init__()
        self.hits = hits
        self.sites = sites

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in SYNC_METHODS and not _staging():
            self.hits.append((name, _site()) if self.sites else name)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def audit(sites: bool = False):
    """Yields the list of hits made inside the block."""
    hits: list = []
    with AuditPy(hits, sites), Audit(hits, sites):
        yield hits
