"""What a traced run (--trace 1) records beside the frame times.

* `Spans`: the benchmark's own spans around calls into the program's
  layers (wrappers set on the system and on the layers' modules),
  logged on the host's wall clock in ns (the profiler's time base) so
  that an idle gap on the device can be named by the span open on the
  host; while `timed` is set (the traced window's sync stretch), `vi_ba`
  also ends in a device synchronisation and keeps its milliseconds.
* `SyncCounter`: synchronising calls under CUDA sync debugging, counted as
  chip_smoke.py's `_count_syncs` counts them (copied, not imported).
* `device_timeline`: kernel, copy and set intervals of a torch.profiler
  window (CUDA activity only: recording every host operation too doubled
  a frame's time on the card), from its raw events.
"""
from __future__ import annotations

import functools
import time
import warnings

import torch

# (name, attribute of the system) whose calls get a span; names of the
# layers in PERF.md
SYSTEM_SPANS = (("fused_step", "_track_fused"),
                ("staged_step", "_track_frame"),
                ("kf_fused", "_insert_keyframe_fused"),
                ("kf_staged", "_insert_keyframe_staged"),
                ("deferred_kf", "_drain_deferred"),
                ("reloc_attempt", "_reloc_attempt"))
# (name, module, attribute) of the layers' functions that get a span; the
# program calls each through its module, so the wrapper is seen
MODULE_SPANS = (
    ("frame_build", "geoflowslam_tpu_torch.pipeline.fused", "build_frame"),
    ("frame_build", "geoflowslam_tpu_torch.pipeline.system", "build_frame"),
    ("icp", "geoflowslam_tpu_torch.ops.gicp", "gicp_register"),
    ("of", "geoflowslam_tpu_torch.pipeline.of_tracking", "of_dual_stream"),
    ("track_motion_model", "geoflowslam_tpu_torch.pipeline.tracking",
     "track_with_motion_model"),
    ("track_local_map", "geoflowslam_tpu_torch.pipeline.tracking",
     "track_local_map"),
    ("plane_obs", "geoflowslam_tpu_torch.pipeline.lidar_mapping",
     "make_plane_obs"),
    ("vi_refine", "geoflowslam_tpu_torch.pipeline.inertial", "refine_frame"),
    ("recover", "geoflowslam_tpu_torch.pipeline.reloc", "recover_frame"),
    ("mapping", "geoflowslam_tpu_torch.pipeline.local_mapping",
     "mapping_step"),
    ("vi_ba", "geoflowslam_tpu_torch.pipeline.local_mapping", "vi_ba_step"),
)
TIMED = ("vi_ba",)     # spans that synchronise and keep their ms


class Spans:
    def __init__(self, slam, device):
        import importlib
        self.ms = {name: [] for name in TIMED}
        self.log = None      # a list while the profiled frames run
        self.timed = False   # TIMED spans synchronise while set
        self._instance = []  # (object, attribute) set on instances
        for name, attr in SYSTEM_SPANS:
            setattr(slam, attr, self._span(name, getattr(slam, attr), device))
            self._instance.append((slam, attr))
        if slam.loop_closer is not None:
            lc = slam.loop_closer
            lc._verify = self._span("loop_verify", lc._verify, device)
            self._instance.append((lc, "_verify"))
        self._saved = []
        for name, module, attr in MODULE_SPANS:
            mod = importlib.import_module(module)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._span(name, fn, device))

    def _span(self, name, fn, device):
        timed = name in TIMED

        @functools.wraps(fn)
        def wrapped(*a, **k):
            ns0 = time.time_ns()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if timed and self.timed:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                self.ms[name].append((time.perf_counter() - t0) * 1e3)
            if self.log is not None:
                self.log.append((name, ns0, time.time_ns()))
            return out
        return wrapped

    def remove(self):
        """Every wrapper taken off (the instances' own attributes deleted,
        so that their class's methods show again); safe to repeat."""
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        for obj, attr in self._instance:
            if attr in vars(obj):
                delattr(obj, attr)
        self._saved, self._instance = [], []


class SyncCounter:
    """Synchronising calls while active (CUDA sync debugging's warnings)."""

    def __init__(self):
        self.n = 0
        self._ctx = None
        self.active = False

    def __enter__(self):
        self.active = True
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                self.n += 1
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.active = False
        torch.cuda.set_sync_debug_mode("default")
        self._ctx.__exit__(*exc)
        return False


def _activity(name: str) -> str:
    """A device event's kind by its name, as CUPTI names copies and sets."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def device_timeline(prof):
    """Device intervals [(name, start_ns, end_ns, activity)] of a finished
    torch.profiler.profile: the card's kernels, copies and sets."""
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
            _activity(e.name()))
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    ops.sort(key=lambda x: x[1])
    return ops
