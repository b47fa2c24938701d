"""Dense local and global depth-cloud maps and the point-to-plane factors
of the lidar stage (port of geoflowslam_tpu/pipeline/lidar_mapping.py).

* The sliding local map is a fixed-capacity world-frame point buffer: each
  KF's cloud is transformed and appended, the points of KFs below the
  window dropped, and the union voxel-compacted back to capacity
  (ops/pointcloud.voxel_select: one point per voxel, first in a stable key
  sort).
* `make_plane_obs` associates the current cloud with local-map planes: 5
  nearest neighbours by brute force, their 3x3 covariance, its smallest
  eigenvector as the normal (the closed forms of ops/pointcloud: a batched
  `torch.linalg.eigh` would synchronize on CUDA), and the planarity and
  distance gates. A normal's sign may differ from the reference's; the
  offset d = -n . mean follows it, so every residual n . p + d agrees.
* The global map is host-side: decimated world clouds, exported as PCD.
  `add_lazy` starts a non-blocking copy into pinned memory and
  materializes it only when the points are read.

The PlaneObs feeds solvers/pose_opt.pose_optimization.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from geoflowslam_tpu_torch.config import LidarConfig
from geoflowslam_tpu_torch.math.sym_eig import eigvals3
from geoflowslam_tpu_torch.ops import pointcloud as PC
from geoflowslam_tpu_torch.solvers.pose_opt import PlaneObs


class LocalMap(NamedTuple):
    pts: torch.Tensor      # [P, 3] world
    valid: torch.Tensor    # [P] bool
    kf_id: torch.Tensor    # [P] long: the contributing KF slot


def create_local_map(cfg: LidarConfig, device) -> LocalMap:
    n = cfg.local_capacity
    return LocalMap(pts=torch.zeros((n, 3), device=device),
                    valid=torch.zeros((n,), dtype=torch.bool, device=device),
                    kf_id=torch.full((n,), -1, dtype=torch.long,
                                     device=device))


def insert_kf_cloud(lm: LocalMap, cloud_c, cloud_valid, rot_cw, t_cw,
                    kf_slot: int, oldest_keep: int,
                    cfg: LidarConfig) -> LocalMap:
    """Add a KF's camera-frame cloud at Tcw; drop the points of KF slots
    below `oldest_keep`."""
    rot_wc = rot_cw.T
    pts_w = PC.transform_cloud(rot_wc, -rot_wc @ t_cw, cloud_c)
    keep = lm.valid & (lm.kf_id >= oldest_keep)
    all_pts = torch.cat([lm.pts, pts_w], dim=0)
    all_valid = torch.cat([keep, cloud_valid], dim=0)
    all_kf = torch.cat([lm.kf_id, torch.full(
        (pts_w.shape[0],), kf_slot, dtype=torch.long, device=pts_w.device)])
    sel, valid = PC.voxel_select(all_pts, all_valid, cfg.local_voxel,
                                 cfg.local_capacity)
    return LocalMap(pts=all_pts[sel], valid=valid, kf_id=all_kf[sel])


def make_plane_obs(lm: LocalMap, cloud_c, cloud_valid, rot_cw, t_cw,
                   cfg: LidarConfig) -> PlaneObs:
    """Point-to-plane factors of the cloud at Tcw against the local map."""
    rot_wc = rot_cw.T
    pts_w = PC.transform_cloud(rot_wc, -rot_wc @ t_cw, cloud_c)
    idx, d2, ok = PC.knn_indices(pts_w, cloud_valid, lm.pts, lm.valid,
                                 cfg.knn)
    nb = lm.pts[idx]                                     # [L, k, 3]
    w = ok.to(pts_w.dtype)
    n_valid = torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1.0)
    mean = torch.sum(nb * w[..., None], dim=1) / n_valid
    c = (nb - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("lki,lkj->lij", c, c) / n_valid[..., None]
    vals = eigvals3(cov)
    normal = PC.smallest_eigvec_sym3(cov)
    # planar: a small plane-fit residual, the next eigenvalue well above it
    planar = ((torch.sqrt(torch.clamp_min(vals[:, 0], 0.0))
               < cfg.planarity_eps)
              & (vals[:, 1] > 4.0 * vals[:, 0] + 1e-12))
    d = -torch.sum(normal * mean, dim=1)
    close = d2[:, 0] < cfg.max_plane_dist ** 2
    valid = (cloud_valid & ok[:, 0] & planar & close
             & (torch.sum(w, dim=1) >= cfg.knn - 1))
    return PlaneObs(pts_c=cloud_c, normal=normal, d=d, valid=valid)


class GlobalMap:
    """The host-side global cloud: world points of every KF, decimated to
    one per `global_voxel` when read."""

    def __init__(self, cfg: LidarConfig):
        self.cfg = cfg
        self.chunks: list = []
        self._lazy: list = []

    def add(self, cloud_c, cloud_valid, rot_cw, t_cw):
        """Add a KF's camera-frame cloud at Tcw (reads the device)."""
        r = _np(rot_cw)
        pts = _np(cloud_c)[_np(cloud_valid)]
        self.chunks.append(pts @ r + (-r.T @ _np(t_cw)))

    def add_lazy(self, cloud_c, cloud_valid, rot_cw, t_cw):
        """`add` without blocking: CUDA tensors start a non-blocking copy
        into pinned host memory, read (after its event) by points()."""
        args = (cloud_c, cloud_valid, rot_cw, t_cw)
        if not cloud_c.is_cuda:
            self._lazy.append((args, None))
            return
        host = []
        for a in args:
            buf = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            buf.copy_(a, non_blocking=True)
            host.append(buf)
        done = torch.cuda.Event()
        done.record()
        self._lazy.append((tuple(host), done))

    def _drain_lazy(self):
        for args, done in self._lazy:
            if done is not None:
                done.synchronize()
            self.add(*args)
        self._lazy = []

    def points(self) -> np.ndarray:
        """[N, 3] float32 world points, one per occupied global voxel."""
        self._drain_lazy()
        if not self.chunks:
            return np.zeros((0, 3), np.float32)
        allp = np.concatenate(self.chunks, axis=0)
        vox = np.floor(allp / self.cfg.global_voxel).astype(np.int64)
        key = (vox[:, 0] * 73856093 ^ vox[:, 1] * 19349663
               ^ vox[:, 2] * 83492791)
        _, idx = np.unique(key, return_index=True)
        return allp[idx]

    def save_pcd(self, path: str):
        """ASCII PCD export (globalMap.pcd)."""
        pts = self.points()
        with open(path, "w") as f:
            f.write("# .PCD v0.7 - Point Cloud Data file format\n"
                    "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                    f"COUNT 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\n"
                    "VIEWPOINT 0 0 0 1 0 0 0\n"
                    f"POINTS {len(pts)}\nDATA ascii\n")
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
