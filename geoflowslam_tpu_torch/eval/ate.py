"""Trajectory evaluation: ATE / RPE with 6/7-DoF alignment.

A numpy copy of geoflowslam_tpu/eval/ate.py (the port cannot import the JAX
package); a CPU test keeps the two equal. Evaluator semantics
(the reference's script/evaluator/ours/PoseEvaluator.py:16-53 — KITTI-style
ATE/RTE/RRE with Umeyama alignment; script/evaluator/evo associate.py) in
numpy (host-side; evaluation is not a hot path).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def associate(times_a: np.ndarray, times_b: np.ndarray,
              max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (evo/associate.py behaviour)."""
    pairs = []
    j = 0
    for i, ta in enumerate(times_a):
        while j + 1 < len(times_b) and abs(times_b[j + 1] - ta) <= abs(times_b[j] - ta):
            j += 1
        if abs(times_b[j] - ta) <= max_dt:
            pairs.append((i, j))
    return pairs


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid transform aligning src -> dst [N,3]."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    rot = u @ s @ vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        scale = np.trace(np.diag(d) @ s) / var_s
    else:
        scale = 1.0
    t = mu_d - scale * rot @ mu_s
    return scale, rot, t


def ate_rmse(est: Sequence[Tuple[float, np.ndarray]],
             gt: Sequence[Tuple[float, np.ndarray]],
             with_scale: bool = False, max_dt: float = 0.02) -> Dict[str, float]:
    """Absolute trajectory error after alignment. est/gt: [(t, Twc 4x4)]."""
    ta = np.array([e[0] for e in est])
    tb = np.array([g[0] for g in gt])
    pairs = associate(ta, tb, max_dt)
    if len(pairs) < 3:
        return {"ate_rmse": float("inf"), "n_pairs": len(pairs)}
    pe = np.stack([est[i][1][:3, 3] for i, _ in pairs])
    pg = np.stack([gt[j][1][:3, 3] for _, j in pairs])
    s, rot, t = umeyama_align(pe, pg, with_scale)
    err = (s * pe @ rot.T + t) - pg
    rmse = float(np.sqrt((err ** 2).sum(axis=1).mean()))
    return {
        "ate_rmse": rmse,
        "ate_mean": float(np.linalg.norm(err, axis=1).mean()),
        "ate_max": float(np.linalg.norm(err, axis=1).max()),
        "n_pairs": len(pairs),
        "scale": float(s),
    }


def rpe(est: Sequence[Tuple[float, np.ndarray]],
        gt: Sequence[Tuple[float, np.ndarray]], delta: int = 1,
        max_dt: float = 0.02) -> Dict[str, float]:
    """Relative pose error over `delta`-frame intervals (trans m, rot deg)."""
    ta = np.array([e[0] for e in est])
    tb = np.array([g[0] for g in gt])
    pairs = associate(ta, tb, max_dt)
    et, er = [], []
    for k in range(len(pairs) - delta):
        i0, j0 = pairs[k]
        i1, j1 = pairs[k + delta]
        de = np.linalg.inv(est[i0][1]) @ est[i1][1]
        dg = np.linalg.inv(gt[j0][1]) @ gt[j1][1]
        err = np.linalg.inv(dg) @ de
        et.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        er.append(np.degrees(np.arccos(c)))
    if not et:
        return {"rpe_trans": float("inf"), "rpe_rot_deg": float("inf")}
    return {
        "rpe_trans": float(np.sqrt(np.mean(np.square(et)))),
        "rpe_rot_deg": float(np.sqrt(np.mean(np.square(er)))),
    }
