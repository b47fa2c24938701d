"""A cell at a size a CPU test run holds: 320x240, half the features and
OF slots, a short warm-up (for the IMU configuration two keyframes in place
of the IMU's initialization), a window of a few seconds.

`g1_vi_geoflow.walk` is not in BENCHMARK.json (PERF.md: its frame rate
spreads too widely on the card's hosts for a bound); its configuration and
traffic files are kept for a later cell, and run here with the probes and
the limits it was held to on the card, and `k3_pyramid` exact."""
import json
import time

import torch

from slam_bench import cell as C

SEED = 4200000001
G1 = dict(cell={"name": "g1_vi_geoflow.walk", "config": "g1_vi_geoflow",
                "traffic": "walk", "chips": 1},
          probes=["features", "k2", "k3", "poses"],
          limits={"features": 0.001, "k2_rows": 0.0005, "k3_pyramid": 0.0,
                  "k3_px": 0.03, "k3_status": 0.005, "pose_cm": 3.0,
                  "rot_deg": 1.0, "step_cm": 3.0, "step_deg": 0.65})
CELLS = ("tum1_rgbd.handheld", "g1_vi_geoflow.walk")


def spec_of(name):
    manifest = C.load_manifest()
    cell = next((w for w in manifest["workloads"] if w["name"] == name),
                None)
    if cell is not None:
        return C.load_spec(cell, manifest)
    assert name == G1["cell"]["name"], name
    return C.Spec(G1["cell"],
                  _json(C.BENCH / "configs" / "g1_vi_geoflow.json"),
                  _json(C.BENCH / "traffic" / "walk.json"), G1["probes"],
                  dict(G1["limits"]))


def _json(path):
    return json.loads(path.read_text())


def small_run(workload, faults=(), control=False, trace=False,
              seconds=None):
    """run_cell on the CPU at the small size; `faults` are tweak hooks
    (stage, object) applied after the size's. The window holds a few
    frames (the IMU cell's are slower on the CPU) unless `seconds` says."""
    if seconds is None:
        seconds = 12.0 if workload.startswith("g1") else 5.0

    def tweak(stage, obj):
        if stage == "spec":
            s = obj.config["system"]
            for k in ("fx", "fy", "cx", "cy"):
                s[k] /= 2
            s["frame"]["orb"].update(height=240, width=320, n_features=500)
            if s["frame"].get("n_of_slots"):
                s["frame"]["n_of_slots"] = 128
            obj.traffic["warmup"] = {"attr": "_gen_counter", "at_least": 2,
                                     "min_frames": 12, "max_frames": 60}
        if stage == "system":
            # a short window holds few frames: probe every one of them
            obj[1].probed = set(range(200))
        for f in faults:
            f(stage, obj)
    torch.set_num_threads(4)
    return C.run_cell(spec_of(workload), SEED, seconds, trace,
                      time.perf_counter(), device="cpu", tweak=tweak,
                      control=control)
