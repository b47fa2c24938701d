"""Trajectory evaluation CLI of the port (the counterpart of the JAX
package's examples/evaluate_ate.py and of the reference's
PoseEvaluatorTUM.py): ATE RMSE, mean and max after a 6-DoF (or, with
--scale, 7-DoF) alignment, and the RPE, of two TUM-format trajectories.

    python3 geoflowslam_tpu_torch/tools/evaluate_ate.py <est_tum.txt> \
        <gt_tum.txt> [--scale] [--max-dt 0.02]

Host-only: numpy, no device.
"""
from __future__ import annotations

import argparse
import os
import sys

if __name__ == "__main__":   # run as a script: the checkout's root
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))

from geoflowslam_tpu_torch.eval.ate import ate_rmse, rpe  # noqa: E402
from geoflowslam_tpu_torch.io.trajectory import \
    load_trajectory_tum  # noqa: E402


def main(argv=None) -> dict:
    """Print the report; returns the ATE dict with the RPE's two keys."""
    ap = argparse.ArgumentParser()
    ap.add_argument("est")
    ap.add_argument("gt")
    ap.add_argument("--scale", action="store_true", help="7-DoF alignment")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args(argv)

    est = load_trajectory_tum(args.est)
    gt = load_trajectory_tum(args.gt)
    m = ate_rmse(est, gt, with_scale=args.scale, max_dt=args.max_dt)
    r = rpe(est, gt, max_dt=args.max_dt)
    print(f"pairs:     {m['n_pairs']}")
    print(f"ATE rmse:  {m['ate_rmse']:.4f} m")
    print(f"ATE mean:  {m['ate_mean']:.4f} m")
    print(f"ATE max:   {m['ate_max']:.4f} m")
    print(f"scale:     {m['scale']:.4f}")
    print(f"RPE trans: {r['rpe_trans']:.4f} m")
    print(f"RPE rot:   {r['rpe_rot_deg']:.4f} deg")
    return {**m, **r}


if __name__ == "__main__":
    main()
