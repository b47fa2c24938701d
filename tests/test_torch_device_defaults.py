"""No public function or method of the port defaults its device to the CPU.

The port's entry points run on the card unless the caller asks for the CPU:
a `device` parameter is required (or defaults to None and follows its
inputs), never "cpu". The scan imports every module of the package and
reads the signatures of its public functions, classes and their methods.
"""
from __future__ import annotations

import importlib
import inspect
import pkgutil

import torch

import geoflowslam_tpu_torch as PKG


def _modules():
    for info in pkgutil.walk_packages(PKG.__path__, PKG.__name__ + "."):
        if ".tools." in info.name or info.name.endswith(".tools"):
            continue      # command-line tools: argparse picks the device
        yield importlib.import_module(info.name)


def _is_cpu(default) -> bool:
    if isinstance(default, str):
        return default.split(":")[0] == "cpu"
    return isinstance(default, torch.device) and default.type == "cpu"


def _callables(mod):
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != \
                mod.__name__:
            continue
        if inspect.isfunction(obj):
            yield f"{mod.__name__}.{name}", obj
        elif inspect.isclass(obj):
            for mname, meth in vars(obj).items():
                if mname.startswith("_") and mname != "__init__":
                    continue
                fn = meth.__func__ if isinstance(
                    meth, (staticmethod, classmethod)) else meth
                if inspect.isfunction(fn):
                    yield f"{mod.__name__}.{name}.{mname}", fn


def test_no_public_device_parameter_defaults_to_cpu():
    found, bad = 0, []
    for mod in _modules():
        for qual, fn in _callables(mod):
            for p in inspect.signature(fn).parameters.values():
                if "device" not in p.name:
                    continue
                found += 1
                if _is_cpu(p.default):
                    bad.append(f"{qual}({p.name}={p.default!r})")
    assert found > 20, f"the scan saw only {found} device parameters"
    assert not bad, "device parameters that default to the CPU: " + \
        ", ".join(bad)


def test_repaired_entry_points_require_a_device():
    from geoflowslam_tpu_torch.io import fixtures as FX
    from geoflowslam_tpu_torch.state import serialize as S
    for fn in (S.load_atlas, FX.export_tum_rgbd, FX.export_euroc,
               FX._render_sequence):
        p = inspect.signature(fn).parameters["device"]
        assert p.kind is inspect.Parameter.KEYWORD_ONLY, fn.__name__
        assert p.default is inspect.Parameter.empty, fn.__name__
