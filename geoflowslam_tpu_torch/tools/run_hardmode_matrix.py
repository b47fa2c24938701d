"""Run the port's hard-mode matrix and write its table (the counterpart of
the JAX package's tools/run_hardmode_matrix.py, on
geoflowslam_tpu_torch/tools/run_hardmode.py).

Each cell is the hard synthetic sequence (epoch stamps, 40 s loop
revisits, rotation bursts, texture-poor segments) in one primary mode, with
loop closing off or on; the `of_icp` cells run the same sequence with the
GeoFlow switches on (dual-stream optical flow and the GICP predictor), and
`rgbd_of_icp_lidar` adds the lidar point-to-plane factors. Run from the
root of a checkout:

    python3 geoflowslam_tpu_torch/tools/run_hardmode_matrix.py \
        [--frames 2000] [--out results_hard_torch] \
        [--cells rgbd,rgbd_of_icp,...] [--force] [--device cuda|cpu]

Every cell is a subprocess of run_hardmode.py (--device passed through)
with its output in <out>/<tag>.log; the runner itself imports nothing of
the package and launches nothing on the card. Cells already in
<out>/matrix.json without an error are skipped unless --force, so an
interrupted matrix resumes where it stopped; matrix.json and matrix.md are
rewritten after every cell. Each row is the cell's hardmode.json (which
records the card it ran on under `device`) with its tag, command and wall
seconds. The device is CUDA unless --device cpu is given; a CUDA device
without CUDA raises before any cell runs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCRIPT = os.path.join("geoflowslam_tpu_torch", "tools", "run_hardmode.py")

# every primary mode x loop closing, and the GeoFlow cells that exist to
# rescue the visual-only failure (tests/test_torch_hardmode_gate.py gates
# the cells of results_hard_torch/matrix.json)
PLANNED = [
    "rgbd", "rgbd_loop",
    "rgbd_inertial", "rgbd_inertial_loop",
    "mono", "mono_loop",
    "rgbd_of_icp", "rgbd_of_icp_loop",
    "rgbd_of_icp_lidar",
]


def cell_cmd(tag: str, frames: int, out_dir: str, device: str = "cuda"):
    """run_hardmode.py's command line for a cell tag
    `<mode>[_of_icp][_loop][_lidar]`."""
    base = tag
    lidar = base.endswith("_lidar")
    if lidar:
        base = base[: -len("_lidar")]
    loop = base.endswith("_loop")
    if loop:
        base = base[: -len("_loop")]
    robust = base.endswith("_of_icp")
    if robust:
        base = base[: -len("_of_icp")]
    cmd = [sys.executable, SCRIPT, "--mode", base, "--frames", str(frames),
           "--out", os.path.join(out_dir, tag)]
    if loop:
        cmd.append("--loop")
    if robust:
        cmd += ["--of", "--icp"]
    if lidar:
        cmd.append("--lidar")
    return cmd + ["--device", device]


def write_tables(cells, out_abs):
    """Write <out_abs>/matrix.md (one row per cell, in PLANNED order) and
    matrix.json (the cell dicts); returns the table."""
    lines = [
        "| run (command) | FPS | ATE rmse | RPE trans / rot | "
        "per-KF cost early->late | maps/state |",
        "|---|---|---|---|---|---|",
    ]
    order = {t: i for i, t in enumerate(PLANNED)}
    for d in sorted(cells.values(),
                    key=lambda d: order.get(d["tag"], 99)):
        if "error" in d:
            lines.append(f"| `{d['cmd']}` | FAILED rc={d['error']} | | | | |")
            continue
        mp = d.get("map", {})
        lines.append(
            f"| `{d['cmd']}` | {d['fps']:.1f} | "
            f"{d['ate_rmse_m']*100:.2f} cm | "
            f"{d['rpe_trans_m']*100:.2f} cm / {d['rpe_rot_deg']:.3f} deg | "
            f"{d['kf_cost_early_ms']:.1f} -> {d['kf_cost_late_ms']:.1f} ms | "
            f"{mp.get('n_maps', '?')} maps, {mp.get('state', '?')} |")
    table = "\n".join(lines)
    os.makedirs(out_abs, exist_ok=True)
    with open(os.path.join(out_abs, "matrix.md"), "w") as f:
        f.write(table + "\n")
    with open(os.path.join(out_abs, "matrix.json"), "w") as f:
        json.dump(list(cells.values()), f, indent=1)
    return table


def check_device(device: str) -> None:
    """Raise when a CUDA device is asked for and there is none."""
    if device.split(":")[0] != "cuda":
        return
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("run_hardmode_matrix: CUDA device requested but "
                           "torch.cuda.is_available() is False")


def main(argv=None) -> dict:
    """Run the cells; returns {tag: row} of matrix.json."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--out", default="results_hard_torch")
    ap.add_argument("--cells", default=",".join(PLANNED),
                    help="comma-separated cell tags (default: full matrix)")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells already present in matrix.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_device(args.device)

    out_abs = os.path.join(HERE, args.out)
    jpath = os.path.join(out_abs, "matrix.json")
    cells = {}
    if os.path.exists(jpath) and not args.force:
        with open(jpath) as f:
            cells = {d["tag"]: d for d in json.load(f) if "error" not in d}

    for tag in args.cells.split(","):
        if tag in cells and not args.force:
            print(f"== {tag}: cached in matrix.json, skipping", flush=True)
            continue
        cmd = cell_cmd(tag, args.frames, args.out, args.device)
        shown = " ".join(cmd[1:])
        print(f"== {tag}: {shown}", flush=True)
        t0 = time.time()
        log = os.path.join(out_abs, f"{tag}.log")
        os.makedirs(out_abs, exist_ok=True)
        with open(log, "w") as lf:
            r = subprocess.run(cmd, cwd=HERE, stdout=lf,
                               stderr=subprocess.STDOUT, text=True)
        cpath = os.path.join(out_abs, tag, "hardmode.json")
        if r.returncode != 0 or not os.path.exists(cpath):
            print(f"   FAILED rc={r.returncode} (see {log})", flush=True)
            cells[tag] = {"tag": tag, "error": r.returncode, "cmd": shown,
                          "device": args.device}
        else:
            with open(cpath) as f:
                d = json.load(f)
            d["tag"] = tag
            d["cmd"] = shown
            d["wall_s"] = round(time.time() - t0, 1)
            cells[tag] = d
            print(f"   done in {d['wall_s']}s: ATE "
                  f"{d['ate_rmse_m']*100:.2f} cm, {d['fps']:.1f} FPS",
                  flush=True)
        write_tables(cells, out_abs)   # persist after every cell

    print(write_tables(cells, out_abs))
    return cells


if __name__ == "__main__":
    main()
