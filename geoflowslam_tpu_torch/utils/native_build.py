"""One-shot build of the native frame loader (port of
geoflowslam_tpu/utils/native_build.py).

The port builds only `native/frame_loader.cpp` (the decode-ahead PNG/PNM
loader behind io/native_loader.FrameLoader), with the host's `g++`, into
geoflowslam_tpu_torch/kernels/_build/ (listed in .gitignore). The source is
read, never written: nothing is built into `native/`. The library's name
carries a hash of the source and the flags, so an edited source builds anew;
the build writes a temporary file and renames it, so processes that build at
once do not read a half-written library. Nothing builds at import: the first
FrameLoader does.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SOURCE = (Path(__file__).resolve().parents[2] / "native"
          / "frame_loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "kernels" / "_build"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_result: dict = {}


def frame_loader_path() -> Optional[Path]:
    """The built library's path (None while the source is missing)."""
    if not SOURCE.exists():
        return None
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libgfs_frame_loader_{h.hexdigest()[:16]}.so"


def ensure_frame_loader() -> Optional[Path]:
    """Build the frame loader library if it is missing (tried once per
    process). Returns its path, or None when there is no source, no `g++`
    or the build failed; the failure's log is in `build_log()`."""
    if "path" in _result:
        return _result["path"]
    out = frame_loader_path()
    _result["path"], _result["log"] = None, ""
    if out is None:
        _result["log"] = f"no source at {SOURCE}"
        return None
    if out.exists():
        _result["path"] = out
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        _result["log"] = "no g++ on PATH"
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        res = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp),
                              "-lz"], capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        _result["log"] = repr(e)
        return None
    _result["log"] = res.stdout + res.stderr
    if res.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    _result["path"] = out
    return out


def build_log() -> str:
    return _result.get("log", "")
