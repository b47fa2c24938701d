"""What decides `correct`: the window's own outputs against the plain
references under slam_bench/reference/.

The probes that a cell runs are named in its limits file
(slam_bench/limits/<workload>.json: {"probes": [...], "limits": {...}}),
and each is a module slam_bench/probes/<probe>.py found by that name:
  * `NUMBERS`: the names of the numbers it reads;
  * `TARGETS`: (module, attribute) of the program's functions that it wraps
    while the window runs (none for a probe of the returned poses);
  * `keep(kept, frame, target, args, kwargs, out)`: on the frames drawn
    from the seed, keeps a device copy (no host read) of what a wrapped
    function was given and returned;
  * `numbers(kept, outputs, lowp)`: after the window, ({number: value},
    {number: items compared}) from the benchmark's own inputs or the
    arguments the program passed; with `lowp=True` the bfloat16 reference
    stands in the program's place (the control).
A probe for a further layer is a file of its own and a name in a limits
file; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import torch

PROBES = Path(__file__).resolve().parent / "probes"
SAMPLE_EVERY = 8     # a frame is probed with probability 1 / SAMPLE_EVERY


def clone(x):
    """A device copy of the tensors in x (nested lists, tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(clone(v) for v in x)
    return x


def load_probe(name: str):
    spec = importlib.util.spec_from_file_location(
        f"slam_bench_probe_{name}", PROBES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Outputs:
    """What the probes' numbers read besides what they kept."""
    stream: object           # gen.traffic.Stream: the benchmark's inputs
    config: dict             # the configuration file
    est_twc: np.ndarray      # [N, 4, 4] the poses the window returned
    index: np.ndarray        # [N] their frames
    judged: np.ndarray       # [N] bool: outside the traffic's gaps


class Probe:
    """Wraps the named probes' targets; keeps their records of the probed
    frames."""

    def __init__(self, names, probed: set):
        self.names = list(names)
        self.mods = [load_probe(n) for n in self.names]
        self.kept = {n: {} for n in self.names}
        self.probed = probed
        self.frame = None            # index of the frame being tracked
        self._installed = []

    def install(self):
        for name, mod in zip(self.names, self.mods):
            for target in getattr(mod, "TARGETS", ()):
                owner = importlib.import_module(target[0])
                fn = getattr(owner, target[1])
                setattr(owner, target[1],
                        self._wrap(fn, mod.keep, self.kept[name], target))
                self._installed.append((owner, target[1], fn))

    def _wrap(self, fn, keep, kept, target):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if self.frame in self.probed:
                keep(kept, self.frame, target, a, k, out)
            return out
        return wrapped

    def remove(self):
        for owner, attr, fn in reversed(self._installed):
            setattr(owner, attr, fn)
        self._installed = []

    def numbers(self, outputs: Outputs, lowp: bool = False):
        """Every number compared, by name, and how many items each
        covers."""
        values, counts = {}, {}
        for name, mod in zip(self.names, self.mods):
            v, c = mod.numbers(self.kept[name], outputs, lowp)
            values.update(v)
            counts.update(c)
        return values, counts


def judge(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): every limit's number read and at
    or under its limit. Numbers without a limit are not compared."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = values.get(name)
        rows.append((name, v, limit))
        if v is None or not np.isfinite(v) or v > limit:
            ok = False
    return ok, rows
