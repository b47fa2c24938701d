"""ctypes wrapper of the native decode-ahead frame loader
(native/frame_loader.cpp; port of geoflowslam_tpu/io/native_loader.py).

`FrameLoader` runs a C++ worker pool decoding images ahead of the consumer
into an ordered bounded queue: the reference's producer/consumer frame
pipeline (System::CreateFrameAndPush + mFrameQueue, src/System.cc:307-402).
The library is built with `g++` at the first FrameLoader
(utils/native_build.ensure_frame_loader, into kernels/_build/); where it
cannot be built, the frames are decoded synchronously in Python
(io/datasets.load_image), as the JAX package does without its library.
`FrameLoader.native` says which decoder runs. Both decoders give the same
float32 images.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Tuple

import numpy as np

from geoflowslam_tpu_torch.io.datasets import load_image
from geoflowslam_tpu_torch.utils.native_build import ensure_frame_loader

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_frame_loader()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.gfs_loader_create.restype = ctypes.c_void_p
    lib.gfs_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.gfs_loader_next.restype = ctypes.c_int
    lib.gfs_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.gfs_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


class FrameLoader:
    """Ordered prefetching loader over (rgb_path, depth_path) lists; yields
    (index, gray float32 [H, W], depth float32 [H, W] x depth_scale or
    None). The attribute `native` says which decoder runs."""

    def __init__(self, rgb_paths: List[str],
                 depth_paths: Optional[List[str]] = None,
                 height: int = 480, width: int = 640,
                 n_threads: int = 2, queue_cap: int = 50,
                 depth_scale: float = 1.0):
        self.h, self.w = height, width
        self.rgb_paths = rgb_paths
        self.depth_paths = depth_paths
        self.depth_scale = depth_scale
        self._handle = None
        lib = _load_lib()
        self.native = lib is not None     # which decoder runs
        if lib is not None:
            n = len(rgb_paths)
            rgb_arr = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
            dep_arr = None
            if depth_paths is not None:
                dep_arr = (ctypes.c_char_p * n)(
                    *[(p or "").encode() for p in depth_paths])
            self._handle = lib.gfs_loader_create(
                rgb_arr, dep_arr, n, n_threads, queue_cap,
                ctypes.c_float(depth_scale))
            self._lib = lib

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray,
                                         Optional[np.ndarray]]]:
        if not self.native:
            for i, p in enumerate(self.rgb_paths):
                g = load_image(p)
                d = None
                if self.depth_paths is not None and self.depth_paths[i]:
                    d = load_image(self.depth_paths[i]) * self.depth_scale
                yield i, g, d
            return
        if self._handle is None:
            raise RuntimeError("FrameLoader: iterated after close()")
        gray = np.zeros((self.h, self.w), np.float32)
        depth = np.zeros((self.h, self.w), np.float32)
        wout, hout, iout = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        fp = ctypes.POINTER(ctypes.c_float)
        while True:
            rc = self._lib.gfs_loader_next(
                self._handle, gray.ctypes.data_as(fp),
                depth.ctypes.data_as(fp), ctypes.byref(wout),
                ctypes.byref(hout), ctypes.byref(iout))
            if rc == 0:
                return
            if rc < 0:
                continue  # decode failure: skipped (the reference warns)
            d = depth.copy() if self.depth_paths is not None else None
            yield int(iout.value), gray.copy(), d

    def close(self):
        if self._handle is not None:
            self._lib.gfs_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
