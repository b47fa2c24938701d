"""Time the frame step's sync-free eigensolvers (math/sym_eig) against the
torch.linalg calls they replace, on the card, at the shapes the paths give
them:

* `sanitize_info`: the 15x15 marginal's PSD clamp, once a `kf`/`prior`
  frame (solvers/inertial.py): the fixed-sweep Jacobi against eigh;
* `f_8pt`: one F-RANSAC's hypotheses, [64, 8, 9] (OFConfig.f_ransac_hyp),
  twice an optical-flow frame (pipeline/of_tracking.py): null_vector and
  drop_smallest_singular3 against two svd calls (ops/ransac._solve_f_8pt
  with and without `svd`);
* `pnp_dlt`: the PnP RANSAC's hypotheses, [128, 12, 12] and their [128, 3,
  3] rotations, once a relocalization attempt: null_vector and svd3
  against two svd calls;
* `eigh3`: the NDT grid's [2048, 3, 3] voxel covariances, once an NDT
  registration: the closed form against eigh.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 geoflowslam_tpu_torch/tools/time_solvers.py

Each case runs both forms on the same inputs, interleaved, REPS times after
a warm-up. Host ms is the wall time of one call up to a
torch.cuda.synchronize() after it (the frame step is bound by its launches,
so this is what a frame pays); device ms is CUDA events around the call.
The eigh/svd forms are timed with nothing queued before them: on a frame
they also wait for all the work queued ahead of them. It prints the card's
name and power limit as nvidia-smi gives them, one JSON line per case
(medians and the largest difference of the two forms' results), and one
JSON line with the cost a frame: the Jacobi's host ms less the plain
form's, times the calls a frame on `inertial` (`kf`/`prior` frames) and on
`of_icp` (frames with optical flow).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

REPS = 30
CALLS_A_FRAME = {"inertial": {"sanitize_info": 1},
                 "of_icp": {"f_8pt": 2}}


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def _time(fn, torch):
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    return out, host, start.elapsed_time(end)


def _cases(torch, dev):
    from geoflowslam_tpu_torch.math import sym_eig as SE
    from geoflowslam_tpu_torch.ops import ransac as RS
    from geoflowslam_tpu_torch.solvers import inertial as VI

    rs = np.random.RandomState(0)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(dev, dtype)

    # a marginal-like 15x15: SPD with a spread of 1e6 and a slightly
    # negative eigenvalue, as a float32 Schur complement leaves one
    q, _ = np.linalg.qr(rs.randn(15, 15))
    ev = np.concatenate([[-1e-3], np.logspace(0, 6, 14)])
    info = t((q * ev) @ q.T)

    def sanitize_eigh():
        i = 0.5 * (info + info.T)
        e, v = torch.linalg.eigh(i)
        i = (v * torch.clamp_min(e, 0.0)[None, :]) @ v.T
        return torch.where(torch.all(torch.isfinite(i)), i, 0.0)

    p1, p2 = t(rs.randn(64, 8, 2)), t(rs.randn(64, 8, 2))

    def f_form(svd):
        f = RS._solve_f_8pt(p1, p2, svd)
        return f / torch.linalg.norm(f.flatten(1), dim=1)[:, None, None]

    a_pnp = t(rs.randn(128, 12, 12))
    m3 = t(rs.randn(128, 3, 3))

    def pnp_jacobi():
        return SE.null_vector(a_pnp), SE.svd3(m3)[1]

    def pnp_svd():
        return (torch.linalg.svd(a_pnp, full_matrices=True)[2][..., 11, :],
                torch.linalg.svd(m3)[1])

    pts = rs.randn(2048, 40, 3) * np.array([0.3, 0.1, 0.01])
    cov = t(np.einsum("vpi,vpj->vij", pts, pts) / 40.0)

    def diff_f(a, b):
        s = torch.sign(torch.sum((a * b).flatten(1), dim=1))[:, None, None]
        return float(torch.max(torch.abs(a - s * b)))

    def diff_null(a, b):
        (na, sa), (nb, sb) = a, b
        s = torch.sign(torch.sum(na * nb, dim=1))[:, None]
        return max(float(torch.max(torch.abs(na - s * nb))),
                   float(torch.max(torch.abs(sa - sb) / sb.max())))

    return [
        ("sanitize_info", "15x15 float32",
         lambda: VI.sanitize_info(info), sanitize_eigh,
         lambda a, b: float(torch.max(torch.abs(a - b)) / 1e6)),
        ("f_8pt", "64 x [8, 9] float32",
         lambda: f_form(False), lambda: f_form(True), diff_f),
        ("pnp_dlt", "128 x [12, 12] + 128 x [3, 3] float32",
         pnp_jacobi, pnp_svd, diff_null),
        ("eigh3", "2048 x [3, 3] float32",
         lambda: SE.eigh3(cov)[0], lambda: torch.linalg.eigh(cov)[0],
         lambda a, b: float(torch.max(torch.abs(a - b)) / b.abs().max())),
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(_card_line(), flush=True)
    rows = {}
    for name, shape, jacobi, plain, diff in _cases(torch, dev):
        for _ in range(3):
            jacobi(), plain()
        rec = {"jacobi": ([], []), "plain": ([], [])}
        for _ in range(REPS):
            for form, fn in (("jacobi", jacobi), ("plain", plain)):
                out, host, device = _time(fn, torch)
                rec[form][0].append(host)
                rec[form][1].append(device)
                if form == "jacobi":
                    out_j = out
                else:
                    out_p = out
        row = {"case": name, "shape": shape,
               "max_rel_diff": diff(out_j, out_p)}
        for form, (host, device) in rec.items():
            row[f"{form}_host_ms"] = float(np.median(host))
            row[f"{form}_device_ms"] = float(np.median(device))
        rows[name] = row
        print(json.dumps(row), flush=True)
    per_frame = {
        path: sum(n * (rows[c]["jacobi_host_ms"] - rows[c]["plain_host_ms"])
                  for c, n in calls.items())
        for path, calls in CALLS_A_FRAME.items()}
    print(json.dumps({"extra_host_ms_a_frame": per_frame,
                      "calls_a_frame": CALLS_A_FRAME}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
