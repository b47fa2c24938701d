"""Hand-written CUDA kernels of the port and their launchers.

The sources live in csrc/ and are built at first use with nvcc for sm_90a
into kernels/_build/ (listed in .gitignore), one nvcc per source started
together, linked into one shared library with a plain C interface that
ctypes loads: a file without PyTorch's headers builds in seconds. Nothing
is built or imported when this module is imported; the CPU tests import it
on machines without nvcc.

Each launcher takes CUDA tensors only, checks device, dtype, shape and
contiguity, launches on PyTorch's current stream without synchronising,
raises if the launch is refused, and adds the launches it made to its
entry of `launch_counts`: one, unless `reps` > 1, which launches the kernel
that many times back to back into the same outputs (same result; it lets a
caller time the kernel alone, without this module's Python). Dispatch
between a kernel and its plain PyTorch version happens in the ops modules (ops/fast.py, ops/matching.py, ops/klt.py), by
the device of the input tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fast_scores.cu", "gated_hamming.cu", "lk_level.cu",
           "hamming_best2.cu")
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")   # used when nvcc is not on PATH
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

# kernel name -> launches since the last reset_launch_counts()
launch_counts = {"fast_scores": 0, "fast_nms_levels": 0,
                 "gated_hamming_search": 0, "lk_level": 0, "lk_pyramid": 0,
                 "hamming_best2": 0}

_lib: Optional[ctypes.CDLL] = None
_build_log = ""
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_NVCC.exists():
        nvcc = str(CUDA_NVCC)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    """Build target, named by a digest of the sources and flags, so that an
    edited source never loads a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"libgfs_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels (once per source digest), one nvcc per source,
    all started together, then link them; returns the library."""
    global _build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = _find_nvcc()
    obj_dir = BUILD_DIR / f"{out.stem}.{os.getpid()}.obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs = [obj_dir / f"{Path(src).stem}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(CSRC_DIR / src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    _build_log = "".join(logs)
    failed = [src for src, proc in zip(SOURCES, procs) if proc.returncode]
    if failed:
        shutil.rmtree(obj_dir, ignore_errors=True)
        raise RuntimeError(f"nvcc failed on {failed}:\n{_build_log}")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                          *(str(o) for o in objs)],
                         capture_output=True, text=True)
    shutil.rmtree(obj_dir, ignore_errors=True)
    _build_log += res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed to link ({res.returncode}):\n"
                           f"{_build_log}")
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """nvcc's output of the last build in this process (ptxas -v lines)."""
    return _build_log


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            # every entry ends in (reps, stream)
            lib.gfs_fast_scores.argtypes = [p, p, p, i, i, f, f, i, p]
            lib.gfs_fast_nms_levels.argtypes = [p, p, p, i, p, f, f, i, i, p]
            lib.gfs_gated_hamming.argtypes = [p] * 9 + [i] * 5 + [p, i, p]
            lib.gfs_lk_level.argtypes = [p, p, i, i, p, p, i, i, i, f, p, p,
                                         p, i, p]
            lib.gfs_lk_pyramid.argtypes = [p] * 5 + [i, p, i, p, p, i, i, f, f,
                                                     i, i, f, p, p, p, i, p]
            lib.gfs_hamming_best2.argtypes = [p, p, i, i, p, i, p]
            for fn in (lib.gfs_fast_scores, lib.gfs_fast_nms_levels,
                       lib.gfs_gated_hamming, lib.gfs_lk_level,
                       lib.gfs_lk_pyramid, lib.gfs_hamming_best2):
                fn.restype = i
            _lib = lib
    return _lib


def _label(name) -> str:
    """A tensor's name in an error: a string, or (field, k) for field of
    search k (formatted only to raise: the checks run on every launch)."""
    return f"searches[{name[1]}] {name[0]}" if isinstance(name, tuple) \
        else name


def _check(name, x: torch.Tensor, dtype, shape) -> None:
    """Raise unless x is a contiguous CUDA tensor of dtype and shape."""
    if (x.dtype is dtype and x.is_cuda and x.shape == shape
            and x.is_contiguous()):
        return
    name = _label(name)
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    raise ValueError(f"{name}: expected a contiguous tensor")


def _call(dev: torch.device, fn, *args) -> int:
    """fn(*args, stream) with dev's current stream as a raw cudaStream_t
    (torch.cuda.current_stream would build a Python Stream object on every
    launch), with dev made the current device only where it is not
    already."""
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    if idx == cur:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def fast_scores(img: torch.Tensor, th_lo: float, th_hi: float,
                reps: int = 1):
    """FAST-9 responses of img [H, W] float32 at two thresholds (kernel
    csrc/fast_scores.cu). Returns (score_lo, score_hi), each [H, W]."""
    h, w = img.shape
    _check("img", img, torch.float32, (h, w))
    lo = torch.empty_like(img)
    hi = torch.empty_like(img)
    err = _call(img.device, load().gfs_fast_scores, img.data_ptr(),
                lo.data_ptr(), hi.data_ptr(), h, w, float(th_lo),
                float(th_hi), int(reps))
    _raise_on(err, "fast_scores")
    launch_counts["fast_scores"] += int(reps)
    return lo, hi


FAST_MAX_LEVELS = 16    # levels the fused kernel's parameter table holds


def fast_nms_levels(levels: Sequence[torch.Tensor], th_lo: float,
                    th_hi: float, border: int, reps: int = 1):
    """FAST-9 at two thresholds with 3x3 non-maximum suppression and the
    border mask, for all pyramid levels in one launch (kernel
    csrc/fast_scores.cu::fast_nms_levels_kernel).

    levels: [h_l, w_l] float32 images. Returns a list of (score_lo,
    score_hi) per level, each [h_l, w_l]: views of one flat buffer."""
    if not 1 <= len(levels) <= FAST_MAX_LEVELS:
        raise ValueError(f"fast_nms_levels: {len(levels)} levels, expected 1 "
                         f"to {FAST_MAX_LEVELS}")
    if border < 0:
        raise ValueError(f"fast_nms_levels: border {border} must be >= 0")
    for lvl, img in enumerate(levels):
        if img.dim() != 2 or img.numel() == 0:
            raise ValueError(f"fast_nms_levels: level {lvl} has shape "
                             f"{tuple(img.shape)}, expected a non-empty "
                             "[H, W]")
        _check(f"levels[{lvl}]", img, torch.float32, img.shape)
        if img.device != levels[0].device:
            raise ValueError("fast_nms_levels: levels on different devices")
    dev = levels[0].device
    n = len(levels)
    hs = [int(img.shape[0]) for img in levels]
    ws = [int(img.shape[1]) for img in levels]
    out = torch.empty((2 * sum(h * w for h, w in zip(hs, ws)),),
                      dtype=torch.float32, device=dev)
    err = _call(dev, load().gfs_fast_nms_levels,
                (ctypes.c_void_p * n)(*(img.data_ptr() for img in levels)),
                (ctypes.c_int * n)(*hs), (ctypes.c_int * n)(*ws), n,
                out.data_ptr(), float(th_lo), float(th_hi), int(border),
                int(reps))
    _raise_on(err, "fast_nms_levels")
    launch_counts["fast_nms_levels"] += int(reps)
    # level l's [2, h, w] pair as two views (few host calls: split, view,
    # unbind)
    chunks = out.split([2 * h * w for h, w in zip(hs, ws)])
    maps = [tuple(c.view(2, h, w).unbind(0))
            for c, h, w in zip(chunks, hs, ws)]
    return maps


HAMMING_MAX_TARGETS = (1 << 23) - 1   # a key's index field in K2 and K4


def _check_desc_aligned(name, x: torch.Tensor) -> None:
    """The Hamming kernels read descriptors 16 bytes at a time."""
    if x.data_ptr() % 16:
        raise ValueError(f"{_label(name)}: expected a 16-byte aligned "
                         "tensor")


def gated_hamming_search(q_uv, q_level, q_valid, q_desc, q_radius,
                         t_uv, t_level, t_valid, t_desc,
                         min_off: int, max_off: int, big: int,
                         reps: int = 1):
    """Gated best/second Hamming search (kernel csrc/gated_hamming.cu).

    q_*: uv [N,2] f32, level [N] i32, valid [N] bool, desc [N,8] i32 (the
    256 descriptor bits, 16-byte aligned), radius [N] f32; t_*: the same
    over [M] without a radius, M < 2^23. Returns (best [N] i32, second [N]
    i32, idx [N] i32), rows of one [3, N] tensor, with (big, big, -1) where
    no target passes the gates."""
    n, m = q_uv.shape[0], t_uv.shape[0]
    _check("q_uv", q_uv, torch.float32, (n, 2))
    _check("q_level", q_level, torch.int32, (n,))
    _check("q_valid", q_valid, torch.bool, (n,))
    _check("q_desc", q_desc, torch.int32, (n, 8))
    _check("q_radius", q_radius, torch.float32, (n,))
    _check("t_uv", t_uv, torch.float32, (m, 2))
    _check("t_level", t_level, torch.int32, (m,))
    _check("t_valid", t_valid, torch.bool, (m,))
    _check("t_desc", t_desc, torch.int32, (m, 8))
    if m > HAMMING_MAX_TARGETS:
        raise ValueError(f"gated_hamming_search: {m} targets, at most "
                         f"{HAMMING_MAX_TARGETS}")
    _check_desc_aligned("q_desc", q_desc)
    _check_desc_aligned("t_desc", t_desc)
    dev = q_uv.device
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    if n:
        err = _call(dev, load().gfs_gated_hamming,
                    q_uv.data_ptr(), q_level.data_ptr(), q_valid.data_ptr(),
                    q_desc.data_ptr(), q_radius.data_ptr(), t_uv.data_ptr(),
                    t_level.data_ptr(), t_valid.data_ptr(), t_desc.data_ptr(),
                    n, m, int(min_off), int(max_off), int(big),
                    out.data_ptr(), int(reps))
        _raise_on(err, "gated_hamming_search")
        launch_counts["gated_hamming_search"] += int(reps)
    return out.unbind(0)


# dynamic shared memory a block may use on the H100 (one warp's template
# must fit: (win + 2)^2 float32)
LK_SMEM_MAX = 232448


def lk_level(img_prev: torch.Tensor, img_next: torch.Tensor,
             pts: torch.Tensor, guess: torch.Tensor, win: int, iters: int,
             min_eig: float, reps: int = 1):
    """One pyramid level of Lucas-Kanade (kernel csrc/lk_level.cu).

    img_prev, img_next: [H, W] f32; pts, guess: [N, 2] f32 (x, y) in level
    coordinates. Returns (pts_out [N, 2] f32, ok [N] bool, err [N] f32)."""
    h, w = img_prev.shape
    n = pts.shape[0]
    _check("img_prev", img_prev, torch.float32, (h, w))
    _check("img_next", img_next, torch.float32, (h, w))
    _check("pts", pts, torch.float32, (n, 2))
    _check("guess", guess, torch.float32, (n, 2))
    if win < 1 or iters < 0:
        raise ValueError(f"lk_level: win {win} and iters {iters} must be "
                         ">= 1 and >= 0")
    if (win + 2) ** 2 * 4 > LK_SMEM_MAX:
        raise ValueError(f"lk_level: win {win} does not fit in shared memory")
    dev = pts.device
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    err = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out, ok, err
    code = _call(dev, load().gfs_lk_level,
                 img_prev.data_ptr(), img_next.data_ptr(), h, w,
                 pts.data_ptr(), guess.data_ptr(), n, int(win), int(iters),
                 float(min_eig), out.data_ptr(), ok.data_ptr(),
                 err.data_ptr(), int(reps))
    _raise_on(code, "lk_level")
    launch_counts["lk_level"] += int(reps)
    return out, ok, err


LK_MAX_LEVELS = 8     # pyramid levels the fused kernel's parameter table holds
LK_MAX_STREAMS = 4


def lk_pyramid(pyr_prev: Sequence[torch.Tensor],
               pyr_next: Sequence[torch.Tensor], pts: torch.Tensor,
               guess: torch.Tensor, levels: Sequence[int], fb_levels: int,
               scale_factor: float, fb_thresh: float, win: int, iters: int,
               min_eig: float, reps: int = 1):
    """Forward-backward pyramidal Lucas-Kanade for S streams in one launch
    (kernel csrc/lk_level.cu::lk_pyramid_kernel).

    pyr_prev, pyr_next: the two pyramids, [h_l, w_l] f32 per level; pts,
    guess: [S, N, 2] f32 (x, y) in level-0 coordinates; levels[s]: forward
    levels of stream s (its backward pass runs min(fb_levels, levels[s])).
    Returns (pts_out [S, N, 2] f32, status [S, N] bool, err [S, N] f32)."""
    n_lv = len(pyr_prev)
    if len(pyr_next) != n_lv or not 1 <= n_lv <= LK_MAX_LEVELS:
        raise ValueError(f"lk_pyramid: pyramids of {n_lv} and {len(pyr_next)} "
                         f"levels, expected equal and 1 to {LK_MAX_LEVELS}")
    if pts.dim() != 3:
        raise ValueError(f"lk_pyramid: pts has shape {tuple(pts.shape)}, "
                         "expected [S, N, 2]")
    s, n = int(pts.shape[0]), int(pts.shape[1])
    _check("pts", pts, torch.float32, (s, n, 2))
    _check("guess", guess, torch.float32, (s, n, 2))
    for lvl, (a, b) in enumerate(zip(pyr_prev, pyr_next)):
        if a.dim() != 2 or a.numel() == 0:
            raise ValueError(f"lk_pyramid: level {lvl} has shape "
                             f"{tuple(a.shape)}, expected a non-empty [H, W]")
        _check(f"pyr_prev[{lvl}]", a, torch.float32, a.shape)
        _check(f"pyr_next[{lvl}]", b, torch.float32, a.shape)
        if a.device != pts.device or b.device != pts.device:
            raise ValueError("lk_pyramid: tensors on different devices")
    levels = [int(v) for v in levels]
    if not 1 <= s <= LK_MAX_STREAMS or len(levels) != s:
        raise ValueError(f"lk_pyramid: {s} streams with {len(levels)} level "
                         f"counts, expected 1 to {LK_MAX_STREAMS} of each")
    if any(not 1 <= v <= n_lv for v in levels) or fb_levels < 1:
        raise ValueError(f"lk_pyramid: levels {levels} and fb_levels "
                         f"{fb_levels} must lie in 1..{n_lv} and be >= 1")
    if win < 1 or iters < 0:
        raise ValueError(f"lk_pyramid: win {win} and iters {iters} must be "
                         ">= 1 and >= 0")
    if (win + 2) ** 2 * 4 > LK_SMEM_MAX:
        raise ValueError(f"lk_pyramid: win {win} does not fit in shared "
                         "memory")
    dev = pts.device
    out = torch.empty((s, n, 2), dtype=torch.float32, device=dev)
    status = torch.empty((s, n), dtype=torch.bool, device=dev)
    err = torch.empty((s, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out, status, err
    ptrs = ctypes.c_void_p * n_lv
    ints = ctypes.c_int * n_lv
    code = _call(dev, load().gfs_lk_pyramid,
                 ptrs(*(a.data_ptr() for a in pyr_prev)),
                 ptrs(*(b.data_ptr() for b in pyr_next)),
                 ints(*(int(a.shape[0]) for a in pyr_prev)),
                 ints(*(int(a.shape[1]) for a in pyr_prev)),
                 (ctypes.c_float * n_lv)(*(1.0 / scale_factor ** lvl
                                           for lvl in range(n_lv))),
                 n_lv, (ctypes.c_int * s)(*levels), s, pts.data_ptr(),
                 guess.data_ptr(), n, int(fb_levels), float(scale_factor),
                 float(fb_thresh), int(win), int(iters), float(min_eig),
                 out.data_ptr(), status.data_ptr(), err.data_ptr(),
                 int(reps))
    _raise_on(code, "lk_pyramid")
    launch_counts["lk_pyramid"] += int(reps)
    return out, status, err


K4_MAX_SEARCHES = 64   # entries of the kernel's parameter table


def hamming_best2_many(searches: Sequence[Sequence[torch.Tensor]], big: int,
                       reps: int = 1):
    """Ungated best/second Hamming searches, all in one launch (kernel
    csrc/hamming_best2.cu).

    searches: 1 to K4_MAX_SEARCHES entries (q_desc [N,8] i32 (the 256
    descriptor bits), q_valid [N] bool, t_desc [M,8] i32, t_valid [M] bool),
    the descriptors 16-byte aligned, M < 2^23, all on one card. A pair with
    an invalid side reads `big`. Returns one (best [N] i32, second [N] i32,
    idx [N] i32) per search, ties to the lowest target index, (big, big, 0)
    for a row with no valid pair: views of one output tensor."""
    if not 1 <= len(searches) <= K4_MAX_SEARCHES:
        raise ValueError(f"hamming_best2_many: {len(searches)} searches, "
                         f"expected 1 to {K4_MAX_SEARCHES}")
    ptrs, dims, ns = [], [], []
    dev = None
    for k, entry in enumerate(searches):
        if len(entry) != 4:
            raise ValueError(f"hamming_best2_many: search {k} has "
                             f"{len(entry)} tensors, expected 4")
        q, qv, t, tv = entry
        n = q.shape[0] if q.dim() else -1
        m = t.shape[0] if t.dim() else -1
        _check(("q_desc", k), q, torch.int32, (n, 8))
        _check(("q_valid", k), qv, torch.bool, (n,))
        _check(("t_desc", k), t, torch.int32, (m, 8))
        _check(("t_valid", k), tv, torch.bool, (m,))
        if m > HAMMING_MAX_TARGETS:
            raise ValueError(f"hamming_best2_many: search {k} has {m} "
                             f"targets, at most {HAMMING_MAX_TARGETS}")
        _check_desc_aligned(("q_desc", k), q)
        _check_desc_aligned(("t_desc", k), t)
        dev = q.device if dev is None else dev
        if any(x.device != dev for x in entry):
            raise ValueError("hamming_best2_many: tensors on different "
                             "devices")
        ptrs += [q.data_ptr(), qv.data_ptr(), t.data_ptr(), tv.data_ptr()]
        dims += [n, m]
        ns.append(n)
    s = len(ns)
    out = torch.empty((3 * sum(ns),), dtype=torch.int32, device=dev)
    if sum(ns):
        err = _call(dev, load().gfs_hamming_best2,
                    (ctypes.c_void_p * (4 * s))(*ptrs),
                    (ctypes.c_int * (2 * s))(*dims), s, int(big),
                    out.data_ptr(), int(reps))
        _raise_on(err, "hamming_best2")
        launch_counts["hamming_best2"] += int(reps)
    # search after search, its best, second and idx: one split, 3 S views
    parts = out.split([n for n in ns for _ in range(3)])
    return [parts[i:i + 3] for i in range(0, 3 * s, 3)]


def hamming_best2(q_desc: torch.Tensor, q_valid: torch.Tensor,
                  t_desc: torch.Tensor, t_valid: torch.Tensor, big: int,
                  reps: int = 1):
    """One ungated best/second Hamming search: hamming_best2_many's S = 1
    case. Returns (best [N] i32, second [N] i32, idx [N] i32)."""
    return hamming_best2_many([(q_desc, q_valid, t_desc, t_valid)], big,
                              reps)[0]
