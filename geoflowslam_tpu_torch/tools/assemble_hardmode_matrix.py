"""Assemble <out>/matrix.{json,md} from the port's completed hard-mode cells
(the counterpart of the JAX package's tools/assemble_hardmode_matrix.py).

run_hardmode_matrix.py rewrites the matrix after every cell; a cell run
alone (run_hardmode.py --out <out>/<tag>) or a matrix cut short leaves
per-cell <out>/<tag>/hardmode.json files, and this collects whatever is
there into the same two files, so that tests/test_torch_hardmode_gate.py
covers every cell that completed. Each row is the cell's hardmode.json
(with the card it ran on under `device`), its tag and the command line
of its recorded flags. Run from the root of a checkout:

    python3 geoflowslam_tpu_torch/tools/assemble_hardmode_matrix.py \
        [--out results_hard_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

if __name__ == "__main__":   # run as a script: the checkout's root
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))

from geoflowslam_tpu_torch.tools.run_hardmode_matrix import (  # noqa: E402
    HERE, SCRIPT, write_tables)


def recorded_cmd(d: dict, out_dir: str) -> str:
    """The run_hardmode.py command line of a hardmode.json's own flags."""
    cmd = [SCRIPT, "--mode", d.get("mode", "?"), "--frames",
           str(d.get("frames", "?")), "--out", out_dir]
    cmd += [f"--{k}" for k in ("loop", "of", "icp", "lidar") if d.get(k)]
    return " ".join(cmd + ["--device",
                           "cpu" if d.get("device") == "cpu" else "cuda"])


def main(argv=None) -> dict:
    """Collect the cells; returns {tag: row} as written to matrix.json."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results_hard_torch")
    args = ap.parse_args(argv)
    root = os.path.join(HERE, args.out)

    cells = {}
    for jpath in sorted(glob.glob(os.path.join(root, "*", "hardmode.json"))):
        tag = os.path.basename(os.path.dirname(jpath))
        with open(jpath) as f:
            d = json.load(f)
        d["tag"] = tag
        d.setdefault("cmd", recorded_cmd(d, os.path.join(args.out, tag)))
        cells[tag] = d
    if not cells:
        raise SystemExit(f"no per-cell hardmode.json under {root}")
    print(write_tables(cells, root))
    print(f"\nwrote {root}/matrix.json ({len(cells)} cells)")
    return cells


if __name__ == "__main__":
    main()
