"""k3_pyramid, k3_px, k3_status: every optical-flow track (ops/klt.py's
`fb_klt_track_streams`, the fused K3) of the probed frames. The reference
builds both frames' flow pyramids from the stream's own images (CLAHE as
the configuration states, then the half-resolution Gaussian pyramid) and
tracks the program's points and guesses through them. `k3_pyramid` is the
largest gap between the program's pyramid levels and the reference's (the
stage that makes them, checked by itself), `k3_px` the largest pixel gap
where both say tracked, `k3_status` the share of points whose status
differs."""
import inspect

import torch

from slam_bench.check import clone
from slam_bench.reference import features as RF
from slam_bench.reference import klt as RK

NUMBERS = ("k3_pyramid", "k3_px", "k3_status")
TARGETS = (("geoflowslam_tpu_torch.ops.klt", "fb_klt_track_streams"),)


def keep(kept, frame, target, args, kwargs, out):
    import geoflowslam_tpu_torch.ops.klt as KL
    bound = inspect.signature(KL.fb_klt_track_streams).bind(*args, **kwargs)
    bound.apply_defaults()
    a = dict(bound.arguments)
    used = min(max(a["max_levels"]), len(a["pyr_prev"]))
    a["pyr_prev"], a["pyr_next"] = a["pyr_prev"][:used], a["pyr_next"][:used]
    kept.setdefault(frame, []).append(
        (clone(a), clone([(r.pts, r.status) for r in out])))


def _pyramid(outputs, idx, n_levels, device):
    frame_cfg = outputs.config["system"]["frame"]
    img = torch.from_numpy(outputs.stream.gray[idx]).to(device).float()
    if frame_cfg.get("use_clahe", True):
        img = RF.clahe(img)
    return RK.lk_pyramid(img, n_levels)


def numbers(kept, outputs, lowp):
    pyr_gap, worst, flips, total = 0.0, 0.0, 0, 0
    for idx, calls in sorted(kept.items()):
        for a, outs in calls:
            dev, n = a["pts_prev"].device, len(a["pyr_prev"])
            ref_prev = _pyramid(outputs, idx - 1, n, dev)
            ref_next = _pyramid(outputs, idx, n, dev)
            for got, want in zip(a["pyr_prev"] + a["pyr_next"],
                                 ref_prev + ref_next):
                pyr_gap = max(pyr_gap, float((got - want).abs().max()))
            for s, (pts, status) in enumerate(outs):
                guess = a["init_guesses"][s]
                guess = a["pts_prev"] if guess is None else guess
                kw = dict(n_levels=a["max_levels"][s],
                          fb_levels=a["fb_levels"],
                          scale_factor=a["scale_factor"],
                          fb_thresh=a["fb_thresh"], win=a["win"],
                          iters=a["iters"], min_eig=a["min_eig"])
                rpts, rstatus, _ = RK.fb_track(ref_prev, ref_next,
                                               a["pts_prev"], guess, **kw)
                if lowp:
                    pts, status, _ = RK.fb_track(ref_prev, ref_next,
                                                 a["pts_prev"], guess,
                                                 lowp=True, **kw)
                both = status & rstatus
                if bool(both.any()):
                    worst = max(worst,
                                float((pts - rpts).abs()[both].max()))
                flips += int((status != rstatus).sum())
                total += status.numel()
    if not total:
        return {}, {}
    return (dict(zip(NUMBERS, (pyr_gap, worst, flips / total))),
            dict.fromkeys(NUMBERS, total))
