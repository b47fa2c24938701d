"""The one traffic generator: a traffic file's parameters and a seed in, a
camera stream out.

A traffic file (slam_bench/traffic/<mix>.json) gives:
  * the room: "room_half_extent_m", "texture_seed", "texture_scale_m";
  * the path: "trajectory", sums of sines per axis of position and rotation
    vector, and "t0_range", the range of the seeded time offset (one second
    wide, so that every seed does alike work; commensurate frequencies give
    a path that returns to views the map holds);
  * "fps", the sensor's frame rate;
  * optionally "gaps": {"first_s", "every_s", "frames": [lo, hi],
    "image": "flat" | "noise", "settle_frames"}: stretches of lo..hi frames
    (the length drawn from the seed) in which the lens is covered (a flat
    grey image, or the seed's noise) and depth reads nothing, the first at
    first_s and one every every_s seconds of the sequence; their frames and
    the settle_frames after each are not judged against the ground truth;
  * "warmup": {"attr", "at_least", "min_frames", "max_frames"}: set-up
    tracks the stream's frames until the system's attribute (a dotted path,
    such as "imu.initialized" or "_gen_counter") reaches at_least;
  * "max_window_fps": the most frames a second the window can consume, a
    stated multiple of the measured pace (PERF.md), so that set-up renders
    no frame that no run uses; a window that runs out of frames ends there.
The configuration gives the camera, the entry point (the images it takes:
"rgbd" gray and depth, "stereo" a rectified pair bf / fx apart,
"monocular" gray; "_inertial" adds the IMU samples), the depth unit of the
sensor, the IMU rate and whether odometry is fed. Frames are rendered on
the device in set-up and kept on the host as a sensor driver hands them
over: gray uint8 and depth float32 in the sensor's units.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from slam_bench.gen.room import Room, Trajectory

GAP_GRAY = 100


@dataclasses.dataclass
class Stream:
    times: np.ndarray          # [N] sequence seconds, float64
    gray: np.ndarray           # [N, H, W] uint8 (the left camera's)
    depth: np.ndarray | None   # [N, H, W] float32, sensor units
    gray_r: np.ndarray | None  # [N, H, W] uint8, the right camera's
    gt_twc: np.ndarray         # [N, 4, 4] float64 ground truth
    imu: tuple | None          # (acc, gyro, dt) of frames 1.., host float32
    odom_v: np.ndarray | None  # [N, 3] float32 world velocities
    judged: np.ndarray         # [N] bool: outside the gaps and their settling
    trajectory: Trajectory


def seeded_rng(seed: int, salt: int) -> np.random.Generator:
    """Independent streams of one seed (any non-negative integer)."""
    return np.random.default_rng([int(seed), salt])


def images_of(entry: str) -> str:
    """"rgbd", "stereo" or "monocular": the images an entry point takes."""
    for kind in ("rgbd", "stereo", "monocular"):
        if entry.startswith(f"track_{kind}"):
            if "fisheye" in entry:
                break
            return kind
    raise ValueError(f"entry {entry!r}: the room renders pinhole rgbd, "
                     f"stereo and monocular cameras only")


def gap_frames(traffic: dict, seed: int, n_frames: int):
    """([N] bool in a gap, [N] bool judged) of the traffic's gaps."""
    gap = np.zeros(n_frames, bool)
    judged = np.ones(n_frames, bool)
    spec = traffic.get("gaps")
    if spec:
        rng, fps = seeded_rng(seed, 3), traffic["fps"]
        lo, hi = spec["frames"]
        k = 0
        while True:
            start = round((spec["first_s"] + k * spec["every_s"]) * fps)
            if start >= n_frames:
                break
            length = int(rng.integers(lo, hi + 1))
            gap[start:start + length] = True
            judged[start:start + length + spec["settle_frames"]] = False
            k += 1
    return gap, judged


def make_stream(traffic: dict, config: dict, seed: int, n_frames: int,
                device) -> Stream:
    """n_frames frames of the traffic at its frame rate, from `seed`."""
    rng = seeded_rng(seed, 0)
    traj = Trajectory(traffic["trajectory"],
                      rng.uniform(*traffic["trajectory"]["t0_range"]))
    fps = traffic["fps"]
    times = np.arange(n_frames, dtype=np.float64) / fps
    system = config["system"]
    kind = images_of(config["entry"])
    cam = dict(fx=system["fx"], fy=system["fy"], cx=system["cx"],
               cy=system["cy"], width=system["frame"]["orb"]["width"],
               height=system["frame"]["orb"]["height"])
    room = Room(cam, traffic["texture_seed"], device,
                half_extent=tuple(traffic["room_half_extent_m"]),
                tex_scale=traffic["texture_scale_m"])
    unit = config["sensor"]["depth_unit_m"]
    rot_cw, t_cw = traj.pose_cw(torch.as_tensor(times, dtype=torch.float32,
                                                device=device))
    gap, judged = gap_frames(traffic, seed, n_frames)
    shape = (n_frames, cam["height"], cam["width"])
    gray = torch.empty(shape, dtype=torch.uint8, device=device)
    depth = torch.empty(shape, device=device) if kind == "rgbd" else None
    gray_r = (torch.empty(shape, dtype=torch.uint8, device=device)
              if kind == "stereo" else None)
    right = torch.tensor([-system["bf"] / system["fx"], 0.0, 0.0],
                         device=device)
    noise = torch.Generator(device=device)
    noise.manual_seed(int(seeded_rng(seed, 4).integers(2 ** 62)))
    for i in range(n_frames):
        if gap[i]:
            if traffic["gaps"]["image"] == "noise":
                g = torch.randint(0, 256, shape[1:], generator=noise,
                                  device=device, dtype=torch.uint8)
            else:
                g = torch.full(shape[1:], GAP_GRAY, dtype=torch.uint8,
                               device=device)
            gray[i] = g
            if depth is not None:
                depth[i] = 0.0
            if gray_r is not None:
                gray_r[i] = g
            continue
        g, d = room.render(rot_cw[i], t_cw[i])
        gray[i] = torch.clamp(torch.round(g), 0, 255).to(torch.uint8)
        if depth is not None:
            depth[i] = torch.round(d / unit)
        if gray_r is not None:
            g, _ = room.render(rot_cw[i], t_cw[i] + right)
            gray_r[i] = torch.clamp(torch.round(g), 0, 255).to(torch.uint8)
    imu = None
    if system.get("imu") is not None:
        imu = traj.imu(times, config["sensor"]["imu_rate"],
                       system["imu"].get("max_samples_per_frame", 32), device)
    odom = None
    if config["sensor"].get("odometry"):
        odom = traj(torch.as_tensor(times))[2].float().numpy()

    def host(x):
        return None if x is None else x.cpu().numpy()
    return Stream(times=times, gray=host(gray), depth=host(depth),
                  gray_r=host(gray_r), gt_twc=traj.twc_np(times), imu=imu,
                  odom_v=odom, judged=judged, trajectory=traj)


def frames_needed(traffic: dict, seconds: float) -> int:
    """Frames to render: the warm-up's most and what the window can
    consume at the traffic's cap."""
    return (traffic["warmup"]["max_frames"]
            + math.ceil(seconds * traffic["max_window_fps"]) + 1)
