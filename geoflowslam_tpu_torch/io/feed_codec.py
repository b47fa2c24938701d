"""The packed m12 frame feed (port of geoflowslam_tpu/io/feed_codec.py).

One frame as one 1-D uint8 buffer:

    [ gray u8 (H*W) | depth 12-bit, 2 px -> 3 bytes (H*W/2*3) ]

Depth is quantized to 12 bits at 4 mm a step (16.4 m of range); 0 is
invalid. `pack_m12` is the host packer (numpy, rounding half up);
`pack_m12_torch` packs a render on its device the way the hard-mode script
does (rounding half to even, as torch.round does); `unpack_m12_np` is the
host unpack; state/frame.build_frame unpacks on the buffer's device.
"""
from __future__ import annotations

import numpy as np
import torch

M12_STEP_M = 0.004        # metres per 12-bit depth step (4 mm)
M12_MAX_Q = 4095
_INV_STEP_F32 = float(np.float32(1.0) / np.float32(M12_STEP_M))


def packed_size(h: int, w: int) -> int:
    assert w % 2 == 0
    return h * w + (h * w // 2) * 3


def pack_m12(gray: np.ndarray, depth: np.ndarray,
             depth_unit_m: float) -> np.ndarray:
    """Pack (gray [H, W] uint8-able, depth [H, W] in `depth_unit_m` units)
    into the 1-D uint8 buffer. Invalid or out-of-range depth packs to 0."""
    h, w = gray.shape
    g = gray if gray.dtype == np.uint8 else \
        np.clip(gray, 0, 255).astype(np.uint8)
    scale = depth_unit_m / M12_STEP_M
    q = np.floor(np.clip(depth.astype(np.float32) * scale, 0, M12_MAX_Q)
                 + 0.5).astype(np.uint16)
    a, b = q[:, 0::2], q[:, 1::2]
    out = np.empty((h, w // 2, 3), np.uint8)
    out[..., 0] = a & 0xFF
    out[..., 1] = ((a >> 8) | ((b & 0xF) << 4)).astype(np.uint8)
    out[..., 2] = (b >> 4).astype(np.uint8)
    return np.concatenate([g.reshape(-1), out.reshape(-1)])


def unpack_m12_np(buf: np.ndarray, h: int, w: int):
    """Host unpack: (gray u8 [H, W], depth_q u16 [H, W] in 4 mm steps)."""
    g = buf[:h * w].reshape(h, w)
    p = buf[h * w:].reshape(h, w // 2, 3).astype(np.uint16)
    a = p[..., 0] | ((p[..., 1] & 0xF) << 8)
    b = (p[..., 1] >> 4) | (p[..., 2] << 4)
    q = np.stack([a, b], -1).reshape(h, w)
    return g, q


def pack_m12_torch(gray: torch.Tensor, depth_m: torch.Tensor) -> torch.Tensor:
    """Pack float gray [..., H, W] and metric depth [..., H, W] on their
    device: round (half to even), clip to 0..255 and 0..4095, two depth
    pixels into three bytes, as the JAX hard-mode script's render_packed.
    Returns uint8 [..., packed_size(H, W)]."""
    lead = gray.shape[:-2]
    gq = torch.clamp(torch.round(gray), 0, 255).to(torch.uint8)
    # XLA compiles the script's d / 0.004 to a product with the float32
    # reciprocal (249.99998), which rounds otherwise on exact half steps
    q = torch.clamp(torch.round(depth_m * _INV_STEP_F32), 0,
                    M12_MAX_Q).to(torch.int32)
    a, b = q[..., 0::2], q[..., 1::2]
    p = torch.stack([a & 0xFF, (a >> 8) | ((b & 0xF) << 4), b >> 4],
                    -1).to(torch.uint8)
    return torch.cat([gq.reshape(*lead, -1), p.reshape(*lead, -1)], -1)


def unpack_m12_torch(buf: torch.Tensor, h: int, w: int,
                     depth_map_factor: float):
    """Unpack a 1-D uint8 buffer on its device: (gray float32 [H, W],
    depth float32 [H, W] in input units, q x 0.004 / depth_map_factor)."""
    p = buf[h * w:].reshape(h, w // 2, 3).to(torch.int32)
    a = p[..., 0] | ((p[..., 1] & 0xF) << 8)
    b = (p[..., 1] >> 4) | (p[..., 2] << 4)
    q = torch.stack([a, b], -1).reshape(h, w).float()
    depth = q * (M12_STEP_M / depth_map_factor)
    return buf[:h * w].reshape(h, w).float(), depth
