"""features: the frame build's feature stage (state/frame.py's `extract`:
CLAHE, pyramid, the fused K1 with NMS, the keypoint selection, ORB),
recomputed from the stream's own image. The number is the share of
keypoint slots of the probed frames whose validity, pixel, octave or any
descriptor bit differs from the reference's."""
import torch

from slam_bench.check import clone
from slam_bench.reference import features as RF

NUMBERS = ("features",)
TARGETS = (("geoflowslam_tpu_torch.state.frame", "extract"),)


def keep(kept, frame, target, args, kwargs, out):
    kept.setdefault(frame, clone((out.uv, out.level, out.desc, out.valid)))


def numbers(kept, outputs, lowp):
    frame_cfg = outputs.config["system"]["frame"]
    orb, clahe = frame_cfg["orb"], frame_cfg.get("use_clahe", True)
    bad = total = 0
    for idx, got in sorted(kept.items()):
        gray = torch.from_numpy(outputs.stream.gray[idx]).to(got[0].device)
        ref = RF.extract(gray, orb, clahe)
        if lowp:
            got = RF.extract(gray, orb, clahe, lowp=True)
        uv, lvl, desc, valid = got
        ruv, rlvl, rdesc, rvalid = ref
        differ = (valid != rvalid) | (valid & (
            (uv != ruv).any(dim=1) | (lvl.int() != rlvl)
            | (desc != rdesc).any(dim=1)))
        bad += int(differ.sum())
        total += differ.numel()
    return ({"features": bad / total if total else None},
            {"features": total})
