"""Dataset loaders: TUM RGB-D, EuRoC, and the reference's Go2/G1 layout
(port of geoflowslam_tpu/io/datasets.py; host numpy, no torch).

Host-side equivalents of the reference's Examples/ dataset mains
(Examples/RGB-D/rgbd_tum.cc LoadImages + association files;
Examples/RGB-D-Inertial/rgbd_inertial.cc:70-86 which loads `imu/imu.txt` and
optional `imu/odom.txt`; Examples/Monocular-Inertial/mono_inertial_euroc.cc
EuRoC cam0/data + imu0/data.csv).

Images are decoded with the lightweight PGM/PPM/PNG readers below (OpenCV is
not a dependency of this framework; PNG via the pure-python decoder, and
datasets converted to pgm work out of the box).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Minimal image decoding (grayscale PGM/PPM + 8/16-bit grayscale PNG)
# ---------------------------------------------------------------------------

def _read_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data[:2] in (b"P5", b"P6", b"P2"):
        raise ValueError(f"unsupported PNM magic in {path}")
    # parse header tokens, skipping comments
    tokens, i = [], 2
    while len(tokens) < 3:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    w, h, maxval = int(tokens[0]), int(tokens[1]), int(tokens[2])
    i += 1
    if data[:2] == b"P5":
        img = np.frombuffer(data, dtype=">u2" if maxval > 255 else np.uint8,
                            count=w * h, offset=i)
        return np.asarray(img, np.float32).reshape(h, w)
    if data[:2] == b"P6":
        img = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=i)
        rgb = img.reshape(h, w, 3).astype(np.float32)
        return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    raise ValueError("ASCII PNM not supported")


def _paeth(a, b, c):
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def _read_png_gray(path: str) -> np.ndarray:
    """Pure-python PNG reader for grayscale / RGB(A), 8 or 16 bit (covers TUM
    rgb (8-bit RGB) and depth (16-bit gray) images)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", f"not a PNG: {path}"
    pos, idat, meta = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            w, h, bitd, color, comp, filt, inter = struct.unpack(">IIBBBBB", chunk)
            meta = (w, h, bitd, color)
            assert inter == 0, "interlaced PNG unsupported"
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    w, h, bitd, color = meta
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    bpp = nch * (bitd // 8)
    raw = zlib.decompress(b"".join(idat))
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    o = 0
    for y in range(h):
        ftype = raw[o]
        line = np.frombuffer(raw, np.uint8, stride, o + 1).copy()
        o += 1 + stride
        if ftype == 1:   # sub
            for x in range(bpp, stride):
                line[x] = (line[x] + line[x - bpp]) & 0xFF
        elif ftype == 2:  # up
            line = (line + prev) & 0xFF
        elif ftype == 3:  # average
            for x in range(stride):
                left = line[x - bpp] if x >= bpp else 0
                line[x] = (line[x] + ((int(left) + int(prev[x])) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for x in range(stride):
                left = line[x - bpp] if x >= bpp else np.uint8(0)
                ul = prev[x - bpp] if x >= bpp else np.uint8(0)
                line[x] = (line[x] + _paeth(np.uint8(left), prev[x], np.uint8(ul))) & 0xFF
        out[y] = line
        prev = line
    img = out.reshape(h, w, bpp)
    if bitd == 16:
        vals = (img[..., 0::2].astype(np.uint16) << 8) | img[..., 1::2]
        vals = vals.reshape(h, w, nch)
    else:
        vals = img.reshape(h, w, nch)
    if nch >= 3:
        g = (0.299 * vals[..., 0] + 0.587 * vals[..., 1] + 0.114 * vals[..., 2])
        return g.astype(np.float32)
    return vals[..., 0].astype(np.float32)


def load_image(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        return _read_pnm(path)
    if ext == ".png":
        return _read_png_gray(path)
    raise ValueError(f"unsupported image format: {path}")


# ---------------------------------------------------------------------------
# TUM RGB-D
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RGBDFrameRef:
    time: float
    rgb_path: str
    depth_path: Optional[str]


def load_tum_associations(seq_dir: str, assoc_file: str) -> List[RGBDFrameRef]:
    """Parse an association.txt (rgbd_tum.cc LoadImages format:
    `t_rgb rgb/... t_depth depth/...`)."""
    out = []
    with open(assoc_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append(RGBDFrameRef(
                time=float(parts[0]),
                rgb_path=os.path.join(seq_dir, parts[1]),
                depth_path=os.path.join(seq_dir, parts[3]),
            ))
    return out


def load_imu_txt(path: str) -> np.ndarray:
    """`imu/imu.txt` rows: t, wx, wy, wz, ax, ay, az (comma or space sep;
    rgbd_inertial.cc:70-86)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip().replace(",", " ")
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            rows.append(vals[:7])
    return np.asarray(rows, np.float64)


def load_odom_txt(path: str) -> np.ndarray:
    """`imu/odom.txt` rows: t, vx, vy, vz (robot base velocity)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip().replace(",", " ")
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            rows.append(vals[:4])
    return np.asarray(rows, np.float64)


def load_euroc(seq_dir: str, cam: str = "cam0"):
    """EuRoC mav0 layout: cam0/data.csv + imu0/data.csv."""
    cam_csv = os.path.join(seq_dir, "mav0", cam, "data.csv")
    frames = []
    with open(cam_csv) as f:
        for line in f:
            if line.startswith("#"):
                continue
            ts, name = line.strip().split(",")[:2]
            frames.append(RGBDFrameRef(
                time=int(ts) * 1e-9,
                rgb_path=os.path.join(seq_dir, "mav0", cam, "data", name),
                depth_path=None))
    imu_csv = os.path.join(seq_dir, "mav0", "imu0", "data.csv")
    imu = []
    with open(imu_csv) as f:
        for line in f:
            if line.startswith("#"):
                continue
            vals = [float(v) for v in line.strip().split(",")]
            imu.append([vals[0] * 1e-9] + vals[1:7])
    return frames, np.asarray(imu, np.float64)


def imu_between(imu: np.ndarray, t0: float, t1: float, max_samples: int):
    """Slice IMU rows in (t0, t1] into padded (acc, gyro, dts) arrays
    (Tracking::PreintegrateIMU's queue consumption)."""
    sel = imu[(imu[:, 0] > t0) & (imu[:, 0] <= t1)]
    n = min(len(sel), max_samples)
    acc = np.zeros((max_samples, 3), np.float32)
    gyro = np.zeros((max_samples, 3), np.float32)
    dts = np.zeros((max_samples,), np.float32)
    prev_t = t0
    for i in range(n):
        t = sel[i, 0]
        gyro[i] = sel[i, 1:4]
        acc[i] = sel[i, 4:7]
        dts[i] = t - prev_t
        prev_t = t
    return acc, gyro, dts
