"""Configuration dataclasses of the port.

Frozen copies of the JAX package's OrbConfig (ops/extractor.py), FrameConfig
(state/frame.py), TrackConfig (pipeline/tracking.py), MappingConfig
(pipeline/local_mapping.py), LoopConfig (pipeline/loop_closing.py),
ImuConfig (pipeline/inertial.py), LidarConfig (pipeline/lidar_mapping.py),
StereoFisheyeConfig and SystemConfig (pipeline/system.py), with the same
fields and defaults.
The port cannot import the JAX package
(its __init__ imports jax), so the fields are copied here and a CPU test
keeps them equal to the originals.

SystemConfig carries every field of the reference, including the options
the port does not have yet (the monocular sensor, local BA off); the port's
SlamSystem refuses a config that turns any of them on. `loop` takes
this module's LoopConfig, `imu` this module's ImuConfig, `stereo_fisheye`
this module's StereoFisheyeConfig.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

TH_LOW = 50      # ORBmatcher::TH_LOW
TH_HIGH = 100    # ORBmatcher::TH_HIGH


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """Mirrors the ORBextractor.* YAML block."""
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    height: int = 480
    width: int = 640
    cell_size: int = 32
    per_cell_cap: int = 8

    def per_level_quota(self):
        """Geometric distribution of features over levels (reference ctor)."""
        inv = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - inv) / (1 - inv ** self.n_levels)
        quotas, total = [], 0
        for lvl in range(self.n_levels - 1):
            q = int(round(n_desired * inv ** lvl))
            quotas.append(q)
            total += q
        quotas.append(max(self.n_features - total, 0))
        return quotas

    def scale_factors(self):
        return [self.scale_factor ** l for l in range(self.n_levels)]


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    orb: OrbConfig = OrbConfig()
    use_clahe: bool = True
    lk_levels: int = 4
    cloud_stride: int = 4
    cloud_max_pts: int = 4096
    cloud_voxel: float = 0.05
    max_depth: float = 10.0
    bf: float = 40.0
    depth_map_factor: float = 1.0
    n_of_slots: int = 0
    camera_model: str = "pinhole"
    dist_params: tuple = ()
    lidar_features: bool = False
    feed_codec: str = "raw"


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 320.0
    cy: float = 240.0
    bf: float = 40.0
    n_levels: int = 8
    scale_factor: float = 1.2
    search_radius_mm: float = 15.0   # SearchByProjection th (motion model)
    search_radius_lm: float = 5.0    # SearchLocalPoints base radius
    match_max_dist: int = TH_HIGH
    min_inliers: int = 10
    local_window: int = 10           # K1 covisible KFs
    lm_max_candidates: int = 2048    # cap on projected local-map points
    max_new_mp_per_kf: int = 256
    close_depth: float = 3.5         # mThDepth analogue for RGBD points


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 320.0
    cy: float = 240.0
    bf: float = 40.0
    scale_factor: float = 1.2
    window_opt: int = 8      # optimized KFs (covisibility window)
    window_fixed: int = 4    # fixed anchor KFs (1-ring)
    ba_max_pts: int = 1024   # landmark slots in the BA problem
    cull_found_ratio: float = 0.25
    cull_min_obs: int = 2


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    min_score: float = 0.05
    min_sim3_inliers: int = 20
    fix_scale: bool = True         # stereo/RGBD; mono optimizes scale
    covis_edge_min: int = 30       # essential-graph edge threshold
    max_edges: int = 512
    run_pose_graph: bool = True
    run_global_ba: bool = False    # synchronous GBA right after correction
    async_global_ba: bool = True   # GBA as per-frame micro-steps
    use_icp_loop: bool = False     # UseICPLoop: GICP-refine the loop Sim3
    consistency_needed: int = 3    # consecutive KFs re-detecting a region
    min_proj_verify: int = 25      # guided-projection matches through Sim3
    run_weld: bool = True          # SearchAndFuse + welding local BA
    # drift budget of a same-map loop: floor + rate * |t_cur - t_cand|
    drift_budget_floor_m: float = 0.30
    drift_budget_rate: float = 0.02       # m per second of separation
    drift_budget_floor_deg: float = 5.0
    drift_budget_rate_deg: float = 0.10   # deg per second of separation
    # minimum out-of-plane extent (metres) of the Sim3 inlier consensus
    min_structure_m: float = 0.05


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    freq: float = 200.0
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    t_bc: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    max_samples_per_frame: int = 32
    init_min_kfs: int = 5
    init_min_time: float = 1.0
    # IMU.IMUMethod: 0 = MAP-style (gyro GN + linear gravity/scale/
    # velocity), 1 = VIG-Init (the same linear closed form), 2 = the
    # analytic accelerometer solve that also estimates the accelerometer
    # bias under the |g| constraint
    imu_method: int = 0

    def calib(self):
        from geoflowslam_tpu_torch.imu.preintegration import ImuCalib
        return ImuCalib.create(self.t_bc, self.noise_gyro, self.noise_acc,
                               self.walk_gyro, self.walk_acc, self.freq)


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    local_capacity: int = 16384
    local_voxel: float = 0.1       # LidarMapping.LocalResolution
    global_voxel: float = 0.2      # LidarMapping.GlobalResolution
    window_kfs: int = 30           # sliding window of KF slots
    knn: int = 5                   # plane-fit neighbours
    max_plane_dist: float = 0.3    # correspondence gate (m)
    planarity_eps: float = 0.03    # plane-fit residual gate (m)


@dataclasses.dataclass(frozen=True)
class StereoFisheyeConfig:
    """Dual-KB8 stereo rig: the left camera's intrinsics are in FrameConfig
    (camera_model "kb8", dist_params k0..k3); this holds the right camera,
    the rig's extrinsics and the lapping areas."""
    params_r: tuple = ()        # (fx, fy, cx, cy, k0, k1, k2, k3) right cam
    r_lr: tuple = ()            # 3x3 row-major right-cam -> left-cam rotation
    t_lr: tuple = ()            # right-cam -> left-cam translation
    lapping_l: tuple = (0.0, 1e9)   # (u_min, u_max) raw-pixel lapping area
    lapping_r: tuple = (0.0, 1e9)


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 320.0
    cy: float = 240.0
    bf: float = 40.0
    frame: FrameConfig = FrameConfig()
    k_max: int = 256
    m_max: int = 65536
    kf_min_interval: int = 3
    kf_max_interval: int = 15
    kf_tracked_ratio: float = 0.80
    min_inliers_ok: int = 15
    time_recently_lost: float = 5.0
    local_ba_every_kf: bool = True
    imu: Optional[object] = None
    close_depth: float = 0.0
    sensor: str = "rgbd"
    loop: Optional[object] = None
    use_of: bool = False
    use_icp: bool = False
    icp_method: str = "gicp"
    icp_min_inliers: int = 200
    use_odom: bool = False
    use_lidar: bool = False
    use_gms_init: bool = False
    min_kfs_for_new_map: int = 10
    insert_kfs_when_lost: bool = True
    r_odom_cam: Optional[tuple] = None
    max_frame_gap: float = 1.0
    fused_sync_stride: int = 4
    fused_lag: int = 6
    pkt_read_interval: float = 0.25
    pkt_max_pending: int = 16
    record_reproj_err: bool = False
    stereo_fisheye: Optional[StereoFisheyeConfig] = None

    def track_cfg(self) -> TrackConfig:
        return TrackConfig(
            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy, bf=self.bf,
            n_levels=self.frame.orb.n_levels,
            scale_factor=self.frame.orb.scale_factor,
            close_depth=self.close_depth)

    def map_cfg(self) -> MappingConfig:
        return MappingConfig(
            fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy, bf=self.bf,
            scale_factor=self.frame.orb.scale_factor)
