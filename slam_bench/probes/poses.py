"""pose_cm, rot_deg, step_cm, step_deg (and ate_cm, not compared): the
poses the window returned against the stream's ground truth, every frame
outside the traffic's gaps. The largest position (cm) and rotation (deg)
error after one rigid alignment of whole poses, and the largest
frame-to-frame translation (cm) and rotation (deg) error; the control
sets the ground truth computed in bfloat16 in the program's place."""
import numpy as np
import torch

from slam_bench.reference import trajectory as RT

TARGETS = ()
NUMBERS = ("pose_cm", "rot_deg", "step_cm", "step_deg", "ate_cm")


def keep(kept, frame, target, args, kwargs, out):
    pass


def numbers(kept, outputs, lowp):
    idx = outputs.index[outputs.judged]
    est = outputs.est_twc[outputs.judged]
    gt = outputs.stream.gt_twc[idx]
    if lowp:
        t = torch.as_tensor(outputs.stream.times[idx], dtype=torch.bfloat16)
        rot_wc, p, *_ = outputs.stream.trajectory(t)
        est = np.tile(np.eye(4), (len(idx), 1, 1))
        est[:, :3, :3] = rot_wc.float().numpy()
        est[:, :3, 3] = p.float().numpy()
    counts = dict.fromkeys(NUMBERS, len(idx))
    if len(idx) < 3:     # too few answers to align: not read
        return dict.fromkeys(NUMBERS), counts
    pos, rot = RT.pose_errors(est, gt)
    step_t, step_r = RT.step_errors(est, gt)
    return ({"pose_cm": float(pos.max()) * 100.0, "rot_deg": float(rot.max()),
             "step_cm": float(step_t.max()) * 100.0,
             "step_deg": float(step_r.max()),
             "ate_cm": RT.ate_rmse_m(est, gt) * 100.0}, counts)
