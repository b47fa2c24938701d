"""One run of one cell: set-up, the measured window, the check, the line.

The cell's configuration (configs/<config>.json), traffic mix
(traffic/<traffic>.json), probes and limits (limits/<workload>.json, the
probes in probes/<probe>.py) and per-layer readers (metrics/<metric>.py)
are found by the names in BENCHMARK.json; the entry point is the
configuration's "entry" and the warm-up rule the traffic's "warmup".
Nothing here names a cell.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
CLEAN_SHARE = 0.45      # a traced window's clean frames: this share of it
CLEAN_KF = 2            # and until this many of them added a keyframe,
MAX_CLEAN_SHARE = 0.7   # at most this share of it
PROFILED_FRAMES = 12    # then frames under torch.profiler
SYNC_FRAMES = 36        # then at most this many under CUDA sync debugging
FORBIDDEN = ("jax", "jaxlib", "flax", "geoflowslam_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Spec:
    """A cell's files, read by the names in its BENCHMARK.json entry."""
    cell: dict          # the workloads entry
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    probes: list        # the probes of limits/<workload>.json
    limits: dict        # {number: limit}


def load_spec(cell: dict, manifest: dict | None = None) -> Spec:
    """The cell's configuration (the file its configs entry names, else
    configs/<config>.json), traffic and limits."""
    conf = next((c for c in (manifest or {}).get("configs", ())
                 if c["name"] == cell["config"]), None)
    path = (ROOT / conf["file"] if conf is not None
            else BENCH / "configs" / f"{cell['config']}.json")
    lim = json.loads((BENCH / "limits" / f"{cell['name']}.json").read_text())
    return Spec(cell, json.loads(path.read_text()),
                json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                           .read_text()), lim["probes"], lim["limits"])


def find_cell(manifest: dict, workload: str) -> Spec:
    cell = next((w for w in manifest["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    return load_spec(cell, manifest)


def cell_metrics(manifest: dict, workload: str, kind: str) -> list:
    """The end_to_end or per_layer entries that the cell reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"slam_bench_metric_{name.replace('.', '_')}",
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (geoflowslam_tpu_torch is not geoflowslam_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def system_config(system: dict):
    """The port's SystemConfig from a configuration file's "system"."""
    from geoflowslam_tpu_torch import config as C
    d = dict(system)
    frame = dict(d.pop("frame", {}))
    frame["orb"] = C.OrbConfig(**frame.pop("orb", {}))
    if "dist_params" in frame:
        frame["dist_params"] = tuple(frame["dist_params"])
    imu = d.pop("imu", None)
    loop = d.pop("loop", None)
    return C.SystemConfig(
        frame=C.FrameConfig(**frame),
        imu=None if imu is None else C.ImuConfig(**imu),
        loop=None if loop is None else C.LoopConfig(**loop), **d)


@dataclasses.dataclass
class TraceWindow:
    """The profiled frames' device timeline."""
    frames: int
    window_s: float
    busy_s: float
    ops: list            # (name, start_ns, end_ns, activity)
    gaps: list           # (host span, seconds)
    # (first device op's start - window start, window end - last op's end)
    # in ms: small and positive when the profiler's clock is the host's
    clock_check_ms: tuple | None = None

    def kernel_mean_s(self, name: str):
        d = [(e - s) * 1e-9 for n, s, e, a in self.ops
             if a == "kernel" and name in n]
        return sum(d) / len(d) if d else None

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle
        time summed by the benchmark span open on the host (the device
        idles in tens of thousands of gaps of microseconds a frame, so the
        sums say more than the longest few)."""
        def top(pairs):
            acc = {}
            for n, sec in pairs:
                acc[n] = acc.get(n, 0.0) + sec
            return [[n, v] for n, v in
                    sorted(acc.items(), key=lambda x: -x[1])[:10]]
        return {"device_ops": top((n[:120], (e - s) * 1e-9)
                                  for n, s, e, _ in self.ops),
                "idle_gaps": top(self.gaps)}


def timeline(prof, frames: int, spans: list, win: tuple) -> TraceWindow:
    """Busy time (the union of device intervals) inside the profiled
    window `win` (host ns), and each idle gap named by the innermost
    benchmark span of `spans` [(name, start_ns, end_ns)] open on the host
    at its middle."""
    from slam_bench.trace import device_timeline
    ops = device_timeline(prof)
    t0, t1 = win
    busy, gaps, cur_s, cur_e = 0, [], None, t0
    inside = [(max(s, t0), min(e, t1)) for _, s, e, _ in ops
              if e > t0 and s < t1]
    for s, e in sorted(inside) + [(t1, t1)]:
        if s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            mid = (cur_e + s) // 2
            open_spans = [(ss, n) for n, ss, ee in spans
                          if ss <= mid <= ee]
            gaps.append((max(open_spans)[1] if open_spans else "between "
                         "frames", (s - cur_e) * 1e-9))
            cur_s, cur_e = s, e
        else:
            cur_s = s if cur_s is None else cur_s
            cur_e = max(cur_e, e)
    if cur_s is not None and cur_e > cur_s:
        busy += cur_e - cur_s
    check = ((ops[0][1] - t0) * 1e-6,
             (t1 - max(e for _, _, e, _ in ops)) * 1e-6) if ops else None
    return TraceWindow(frames, (t1 - t0) * 1e-9, busy * 1e-9, ops, gaps,
                       check)


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers read."""
    config: dict
    frame_ms: list       # latencies of the clean frames
    kf_added: list | None = None
    span_ms: dict | None = None
    trace: TraceWindow | None = None
    syncs: int | None = None
    sync_frames: int = 0


def process_cpu_s() -> float:
    """This process's CPU seconds, user and system."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def attr_path(obj, path: str):
    """obj.a.b... of a dotted path; None where a link is None."""
    for name in path.split("."):
        obj = getattr(obj, name, None) if obj is not None else None
    return obj


def warm_up(slam, track, warm: dict) -> int:
    """Track the stream's frames until the traffic's warm-up rule holds
    (the system's attribute warm["attr"] at least warm["at_least"], after
    warm["min_frames"]); returns the first frame of the window."""
    def met():
        v = attr_path(slam, warm["attr"])
        return v is not None and v >= warm["at_least"]
    i = 0
    while i < warm["min_frames"] or not met():
        if i >= warm["max_frames"]:
            raise RuntimeError(f"warm-up rule {warm} not met in {i} frames")
        track(i)
        i += 1
    slam.map_stats()            # applies every deferred KF result
    return i


def tracker(slam, config: dict, stream):
    """track(i): frame i through the configuration's entry point, with the
    images it takes, the IMU samples since the previous frame (an inertial
    entry's first frame goes through the entry without them) and the
    odometry queued before it."""
    from slam_bench.gen.traffic import images_of
    entry = config["entry"]
    kind = images_of(entry)
    inertial = entry.endswith("_inertial")
    plain = entry[:-len("_inertial")] if inertial else entry

    def track(i):
        if stream.odom_v is not None:
            slam.set_odom(stream.odom_v[i], odom_frame=False)
        images = {"rgbd": (stream.gray[i], None if stream.depth is None
                           else stream.depth[i]),
                  "stereo": (stream.gray[i], None if stream.gray_r is None
                             else stream.gray_r[i]),
                  "monocular": (stream.gray[i],)}[kind]
        if inertial and i > 0:
            acc, gyro, dts = (x[i - 1] for x in stream.imu)
            return getattr(slam, entry)(*images, acc, gyro, dts,
                                        stream.times[i])
        return getattr(slam, plain)(*images, stream.times[i])
    return track


@dataclasses.dataclass
class Window:
    """What the measured window recorded."""
    index: list          # the frames tracked
    poses: list          # the pose each returned
    frame_ms: list       # latencies of the clean frames
    kf_added: list       # whether each of those frames added a KF
    n_lost: int
    seconds: float       # first call's start to last call's end
    cpu_per_wall: float  # ~1.0: the pace is one host core's
    trace: TraceWindow | None = None
    span_ms: dict | None = None
    syncs: int | None = None
    sync_frames: int = 0


def measure(slam, track, probe, first: int, n_frames: int, seconds: float,
            trace: bool, dev) -> Window:
    """Track frames from `first` until `seconds` have passed or the frames
    run out. A traced window runs in three stretches: first the clean
    frames, as an untraced window runs them (no profiler, no sync
    debugging, no benchmark span), whose latencies the latency readers
    read, for CLEAN_SHARE of the window and until CLEAN_KF of them added a
    keyframe (at most MAX_CLEAN_SHARE of it); then PROFILED_FRAMES frames
    under torch.profiler (CUDA activity) with the benchmark's spans logged;
    then up to SYNC_FRAMES under CUDA sync debugging, with the VI-BA spans
    synchronised and timed."""
    import torch
    from slam_bench.trace import Spans, SyncCounter
    prof, spans, span_log, win_ns = None, None, [], [0, 0]
    syncs = SyncCounter() if trace and dev.type == "cuda" else None
    stage = {"name": "clean" if trace else "untraced", "at": 0}

    def begin_profile(k):
        nonlocal prof, spans
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if dev.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU])
        spans = Spans(slam, dev)
        prof.__enter__()
        spans.log = span_log
        win_ns[0] = time.time_ns()
        stage.update(name="profile", at=k)

    def end_profile(k):
        win_ns[1] = time.time_ns()
        spans.log = None
        prof.__exit__(None, None, None)
        spans.timed = True
        if syncs is not None:
            syncs.__enter__()
        stage.update(name="sync", at=k, profiled=k - stage["at"])

    def end_sync(k):
        spans.timed = False
        if syncs is not None and syncs.active:
            syncs.__exit__(None, None, None)
        spans.remove()
        stage.update(name="after", synced=k - stage["at"])

    frame_ms, kf_added, poses, index = [], [], [], []
    n_lost, i, k, t_first = 0, first, 0, None
    cpu0 = process_cpu_s()
    try:
        while i < n_frames:
            k = i - first
            if t_first is not None and stage["name"] == "clean":
                part = (time.perf_counter() - t_first) / seconds
                if (part >= CLEAN_SHARE and sum(kf_added) >= CLEAN_KF
                        or part >= MAX_CLEAN_SHARE):
                    begin_profile(k)
            elif stage["name"] == "profile" and \
                    k - stage["at"] == PROFILED_FRAMES:
                end_profile(k)
            elif stage["name"] == "sync" and k - stage["at"] == SYNC_FRAMES:
                end_sync(k)
            probe.frame = i
            gen0 = slam._gen_counter
            ns1 = time.time_ns()
            t1 = time.perf_counter()
            pose = track(i)
            t2 = time.perf_counter()
            probe.frame = None
            if t_first is None:
                t_first = t1
            if stage["name"] == "profile":
                span_log.append(("frame", ns1, time.time_ns()))
            elif stage["name"] in ("clean", "untraced"):
                frame_ms.append((t2 - t1) * 1e3)
                kf_added.append(slam._gen_counter != gen0)
            poses.append(pose)
            index.append(i)
            n_lost += slam.state.name != "OK"
            i += 1
            if t2 - t_first >= seconds:
                break
        if stage["name"] == "profile":
            end_profile(k + 1)
    finally:
        if stage["name"] == "profile":     # an error in the profiled frames
            prof.__exit__(None, None, None)
        if stage["name"] in ("profile", "sync"):
            end_sync(k + 1)
    if trace and prof is None:
        raise RuntimeError("the traced window ended before its profiled "
                           "frames")
    win = Window(index, poses, frame_ms, kf_added, n_lost, t2 - t_first,
                 (process_cpu_s() - cpu0) / (t2 - t_first))
    if trace:
        win.trace = timeline(prof, stage["profiled"], span_log,
                             tuple(win_ns))
        win.span_ms = dict(spans.ms)
        win.syncs = None if syncs is None else syncs.n
        win.sync_frames = stage["synced"]
    return win


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", tweak=None,
             control: bool = False, manifest: dict | None = None) -> dict:
    """Run the cell once: {"line": the result line, "info": what the
    earlier lines print, "rows": (name, number, limit) of the check,
    "control": the control's numbers or None}. `tweak`, a test's hook,
    gets the spec, the stream, (the system, the probe), the system before
    the window and the returned poses at the named points before they are
    used. With `control` the numbers of the bfloat16 references put in the
    program's place are computed too (slam_bench/control.py). The metrics
    are those of `manifest`'s entries for the cell (BENCHMARK.json's by
    default)."""
    import torch
    from geoflowslam_tpu_torch.pipeline.system import SlamSystem
    from slam_bench import check
    from slam_bench.gen import traffic as TR

    def hook(stage, obj):
        if tweak is not None:
            tweak(stage, obj)

    # set-up: the program, its kernels, the frames, the warm frames
    manifest = load_manifest() if manifest is None else manifest
    workload = spec.cell["name"]
    hook("spec", spec)
    config, traffic = spec.config, spec.traffic
    dev = torch.device(device)
    cfg = system_config(config["system"])
    marks = [("import", time.perf_counter())]
    if dev.type == "cuda":
        from geoflowslam_tpu_torch import kernels
        kernels.build()
        kernels.load()
    vocab = None
    if config.get("vocabulary") == "shipped":
        from geoflowslam_tpu_torch.retrieval.vocab import default_vocabulary
        vocab = default_vocabulary(dev)
    marks.append(("kernels_vocab", time.perf_counter()))
    n_frames = TR.frames_needed(traffic, seconds)
    stream = TR.make_stream(traffic, config, seed, n_frames, dev)
    marks.append(("render", time.perf_counter()))
    hook("stream", stream)
    slam = SlamSystem(cfg, dev, vocab=vocab)
    rng = TR.seeded_rng(seed, 2)
    probe = check.Probe(spec.probes, set(np.flatnonzero(
        rng.random(n_frames) < 1.0 / check.SAMPLE_EVERY).tolist()))
    probe.install()
    hook("system", (slam, probe))
    marks.append(("system", time.perf_counter()))
    track = tracker(slam, config, stream)

    first = warm_up(slam, track, traffic["warmup"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm_frames", time.perf_counter()))
    setup_parts = {name: round(t - marks[k - 1][1] if k else t - t_start, 3)
                   for k, (name, t) in enumerate(marks)}
    hook("window", slam)

    try:
        win = measure(slam, track, probe, first, n_frames, seconds, trace,
                      dev)
    finally:
        probe.remove()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del slam, track
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, after the window and with the program's state freed
    hook("poses", win.poses)
    index = np.asarray(win.index)
    outputs = check.Outputs(stream, config, np.stack(win.poses), index,
                            stream.judged[index])
    values, counts = probe.numbers(outputs)
    correct, rows = check.judge(values, spec.limits)
    control_values = probe.numbers(outputs, lowp=True)[0] if control else None

    n_window = len(win.index)
    if trace:
        record = RunRecord(config, win.frame_ms, win.kf_added, win.span_ms,
                           win.trace, win.syncs, win.sync_frames)
        metrics = {}
        for m in cell_metrics(manifest, workload, "per_layer"):
            v = load_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"frame_ms_p90": float(np.percentile(win.frame_ms, 90)),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(manifest, workload, "end_to_end")}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{found}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    info = {"frames": n_window, "window_s": win.seconds,
            "frames_per_s": n_window / win.seconds, "setup_s": setup_s,
            "setup_parts_s": setup_parts, "rendered": n_frames,
            "warm_frames": first, "lost_frames": win.n_lost,
            "judged_frames": int(outputs.judged.sum()),
            "frame_ms_samples": len(win.frame_ms), "compared": counts,
            "numbers": values, "process_cpu_per_wall": win.cpu_per_wall,
            "frame_ms_p25_p50_p75_p90": (
                np.percentile(win.frame_ms, [25, 50, 75, 90]).round(1)
                .tolist() if win.frame_ms else None),
            "seed": seed}
    line = {"correct": bool(correct), "attempted": n_window,
            "failed": win.n_lost, "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                       "kind": name, "count": spec.cell["chips"],
                       "memory_peak_bytes": int(peak)}}
    if win.trace is not None:
        info["profiled_frames"] = win.trace.frames
        info["sync_frames"] = win.sync_frames
        info["profiler_clock_check_ms"] = win.trace.clock_check_ms
        line["device"]["busy_s"] = win.trace.busy_s
        line["device"]["window_s"] = win.trace.window_s
        line["breakdown"] = win.trace.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return {"line": line, "info": info, "rows": rows,
            "control": control_values}
