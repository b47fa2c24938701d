"""The SLAM map as fixed-capacity tensors (port of
geoflowslam_tpu/state/map_state.py, the parts the RGB-D, relocalization and
loop-closing slices use).

Keyframes live in K slots and map points in M slots, with validity masks;
`kf_obs_mp` [K, N] maps each keyframe keypoint to a map-point slot (-1 =
none). The covisibility graph is recomputed on demand from the [K, M]
observation incidence. Every mutation returns a new MapState; tensors are
replaced, never written in place, so a caller may keep an older state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from geoflowslam_tpu_torch.ops.indexing import topk_stable

NO_MP = -1


class MapState(NamedTuple):
    kf_rot: torch.Tensor        # [K,3,3] Tcw rotation
    kf_t: torch.Tensor          # [K,3]   Tcw translation
    kf_vel: torch.Tensor        # [K,3]
    kf_bias: torch.Tensor       # [K,6]
    kf_time: torch.Tensor       # [K] f32 seconds since the session base
    kf_valid: torch.Tensor      # [K] bool
    kf_map_id: torch.Tensor     # [K] int32 Atlas map membership
    kf_prev: torch.Tensor       # [K] int32 temporal predecessor (-1 none)
    kf_uv: torch.Tensor         # [K,N,2]
    kf_level: torch.Tensor      # [K,N] int32
    kf_angle: torch.Tensor      # [K,N]
    kf_desc: torch.Tensor       # [K,N,8] int32 descriptor bits
    kf_depth: torch.Tensor      # [K,N]
    kf_kp_valid: torch.Tensor   # [K,N] bool
    kf_obs_mp: torch.Tensor     # [K,N] int32 -> mp slot or -1
    mp_pos: torch.Tensor        # [M,3]
    mp_valid: torch.Tensor      # [M] bool
    mp_desc: torch.Tensor       # [M,8] int32
    mp_normal: torch.Tensor     # [M,3]
    mp_min_dist: torch.Tensor   # [M]
    mp_max_dist: torch.Tensor   # [M]
    mp_found: torch.Tensor      # [M] f32
    mp_visible: torch.Tensor    # [M] f32
    mp_first_kf: torch.Tensor   # [M] int32
    mp_birth_seq: torch.Tensor  # [M] int32 kf_counter at creation
    mp_map_id: torch.Tensor     # [M] int32
    kf_counter: torch.Tensor    # [] int32 total KFs ever inserted
    active_map: torch.Tensor    # [] int32
    n_maps: torch.Tensor        # [] int32
    imu_initialized: torch.Tensor  # [] bool
    viba1_done: torch.Tensor    # [] bool
    viba2_done: torch.Tensor    # [] bool

    @property
    def k_max(self):
        return self.kf_valid.shape[0]

    @property
    def m_max(self):
        return self.mp_valid.shape[0]

    @property
    def n_kp(self):
        return self.kf_uv.shape[1]


def create(k_max: int, n_kp: int, m_max: int,
           device: torch.device | str) -> MapState:
    dev = torch.device(device)
    f = dict(dtype=torch.float32, device=dev)
    i = dict(dtype=torch.int32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    return MapState(
        kf_rot=torch.eye(3, **f).repeat(k_max, 1, 1),
        kf_t=torch.zeros((k_max, 3), **f),
        kf_vel=torch.zeros((k_max, 3), **f),
        kf_bias=torch.zeros((k_max, 6), **f),
        kf_time=torch.zeros((k_max,), **f),
        kf_valid=torch.zeros((k_max,), **b),
        kf_map_id=torch.full((k_max,), -1, **i),
        kf_prev=torch.full((k_max,), -1, **i),
        kf_uv=torch.zeros((k_max, n_kp, 2), **f),
        kf_level=torch.zeros((k_max, n_kp), **i),
        kf_angle=torch.zeros((k_max, n_kp), **f),
        kf_desc=torch.zeros((k_max, n_kp, 8), **i),
        kf_depth=torch.full((k_max, n_kp), -1.0, **f),
        kf_kp_valid=torch.zeros((k_max, n_kp), **b),
        kf_obs_mp=torch.full((k_max, n_kp), NO_MP, **i),
        mp_pos=torch.zeros((m_max, 3), **f),
        mp_valid=torch.zeros((m_max,), **b),
        mp_desc=torch.zeros((m_max, 8), **i),
        mp_normal=torch.zeros((m_max, 3), **f),
        mp_min_dist=torch.zeros((m_max,), **f),
        mp_max_dist=torch.zeros((m_max,), **f),
        mp_found=torch.zeros((m_max,), **f),
        mp_visible=torch.zeros((m_max,), **f),
        mp_first_kf=torch.full((m_max,), -1, **i),
        mp_birth_seq=torch.full((m_max,), -1, **i),
        mp_map_id=torch.full((m_max,), -1, **i),
        kf_counter=torch.zeros((), **i),
        active_map=torch.zeros((), **i),
        n_maps=torch.ones((), **i),
        imu_initialized=torch.zeros((), **b),
        viba1_done=torch.zeros((), **b),
        viba2_done=torch.zeros((), **b),
    )


# ---------------------------------------------------------------------------
# Slot allocation
# ---------------------------------------------------------------------------

def free_kf_slot(ms: MapState) -> torch.Tensor:
    """A free KF slot: the first invalid one, else the oldest KF of a
    dormant map; live KFs of the active map are never chosen while
    kf_capacity_left() > 0."""
    score = torch.where(~ms.kf_valid, -1e9, ms.kf_time + torch.where(
        ms.kf_map_id == ms.active_map, float("inf"), 0.0))
    return torch.argmin(score)


def kf_capacity_left(ms: MapState) -> torch.Tensor:
    """KF slots insertable without evicting a live active-map KF."""
    return (~ms.kf_valid | (ms.kf_map_id != ms.active_map)).sum()


def free_mp_slots(ms: MapState, count: int, use_mask: torch.Tensor):
    """Allocate `count` map-point slots: invalid slots first, then the
    lowest found ratio (ties to the lowest slot). The freest slots go to the
    True positions of `use_mask` [count]; a live slot that is recycled there
    is invalidated and its observations detached first.
    Returns (ms, slots [count] int64)."""
    ratio = ms.mp_found / torch.clamp_min(ms.mp_visible, 1.0)
    score = torch.where(~ms.mp_valid, -1e9, ratio)
    _, idx = topk_stable(score, count, largest=False)
    order = torch.argsort((~use_mask).to(torch.int8), stable=True)
    slots = torch.empty_like(idx)
    slots[order] = idx
    evict = torch.zeros((ms.m_max,), dtype=torch.bool, device=idx.device)
    evict[slots] = use_mask & ms.mp_valid[slots]
    obs = ms.kf_obs_mp
    stale = (obs >= 0) & evict[torch.clamp_min(obs, 0).long()]
    ms = ms._replace(kf_obs_mp=torch.where(stale, NO_MP, obs),
                     mp_valid=ms.mp_valid & ~evict)
    return ms, slots


# ---------------------------------------------------------------------------
# Keyframe and map-point insertion
# ---------------------------------------------------------------------------

def _set_row(arr: torch.Tensor, slot: int, val) -> torch.Tensor:
    out = arr.clone()
    out[slot] = val
    return out


def insert_keyframe(ms: MapState, slot: int, rot, t, time, uv, level, angle,
                    desc, depth, kp_valid, obs_mp, prev_kf: int) -> MapState:
    return ms._replace(
        kf_rot=_set_row(ms.kf_rot, slot, rot),
        kf_t=_set_row(ms.kf_t, slot, t),
        kf_vel=_set_row(ms.kf_vel, slot, 0.0),
        kf_bias=_set_row(ms.kf_bias, slot, 0.0),
        kf_time=_set_row(ms.kf_time, slot, time),
        kf_valid=_set_row(ms.kf_valid, slot, True),
        kf_map_id=_set_row(ms.kf_map_id, slot, ms.active_map),
        kf_prev=_set_row(ms.kf_prev, slot, prev_kf),
        kf_uv=_set_row(ms.kf_uv, slot, uv),
        kf_level=_set_row(ms.kf_level, slot, level),
        kf_angle=_set_row(ms.kf_angle, slot, angle),
        kf_desc=_set_row(ms.kf_desc, slot, desc),
        kf_depth=_set_row(ms.kf_depth, slot, depth),
        kf_kp_valid=_set_row(ms.kf_kp_valid, slot, kp_valid),
        kf_obs_mp=_set_row(ms.kf_obs_mp, slot, obs_mp),
        kf_counter=ms.kf_counter + 1,
    )


def add_map_points(ms: MapState, slots, pos, desc, normal, min_dist, max_dist,
                   first_kf: int, valid_new) -> MapState:
    """Register new map points at `slots` [P] (unique); valid_new masks rows."""
    def upd(arr, vals):
        vals = torch.broadcast_to(torch.as_tensor(vals, dtype=arr.dtype,
                                                  device=arr.device),
                                  (slots.shape[0],) + tuple(arr.shape[1:]))
        keep = valid_new.reshape((-1,) + (1,) * (arr.dim() - 1))
        out = arr.clone()
        out[slots] = torch.where(keep, vals, arr[slots])
        return out

    one = torch.ones_like(ms.mp_found[:1])
    return ms._replace(
        mp_pos=upd(ms.mp_pos, pos),
        mp_valid=upd(ms.mp_valid, True),
        mp_desc=upd(ms.mp_desc, desc),
        mp_normal=upd(ms.mp_normal, normal),
        mp_min_dist=upd(ms.mp_min_dist, min_dist),
        mp_max_dist=upd(ms.mp_max_dist, max_dist),
        mp_found=upd(ms.mp_found, one),
        mp_visible=upd(ms.mp_visible, one),
        mp_first_kf=upd(ms.mp_first_kf, first_kf),
        mp_birth_seq=upd(ms.mp_birth_seq, ms.kf_counter),
        mp_map_id=upd(ms.mp_map_id, ms.active_map),
    )


# ---------------------------------------------------------------------------
# Derived structure
# ---------------------------------------------------------------------------

def observation_incidence(ms: MapState) -> torch.Tensor:
    """[K, M] float32 incidence: KF k observes MP m (duplicates idempotent)."""
    k, n = ms.kf_obs_mp.shape
    m = ms.m_max
    obs = ms.kf_obs_mp.long()
    valid = (obs >= 0) & ms.kf_kp_valid & ms.kf_valid[:, None]
    safe = torch.where(valid, obs, m)
    inc = torch.zeros((k, m + 1), dtype=torch.float32, device=obs.device)
    rows = torch.arange(k, device=obs.device)[:, None].expand(k, n)
    inc[rows, safe] = 1.0
    return inc[:, :m] * ms.mp_valid[None, :]


def covisibility(ms: MapState, incidence=None) -> torch.Tensor:
    """[K, K] int32 shared-observation counts (diagonal zeroed)."""
    inc = observation_incidence(ms) if incidence is None else incidence
    cov = inc @ inc.T
    cov = cov * (1.0 - torch.eye(ms.k_max, dtype=cov.dtype, device=cov.device))
    return cov.to(torch.int32)


def mp_observation_count(ms: MapState, incidence=None) -> torch.Tensor:
    inc = observation_incidence(ms) if incidence is None else incidence
    return torch.sum(inc, dim=0).to(torch.int32)


def local_window(ms: MapState, center_kf: int, k1: int = 10,
                 n_cand: int = 2048, incidence=None):
    """Local-map KF selection: the top-k1 covisible KFs + the centre.
    Returns ([K] bool KF mask, [M] bool MP mask, [n_cand] int64 compacted
    local-MP indices, padded with the first unset index)."""
    inc = observation_incidence(ms) if incidence is None else incidence
    cov = covisibility(ms, incidence=inc)
    row = cov[center_kf] * ms.kf_valid * (ms.kf_map_id == ms.active_map)
    top_v, top = topk_stable(row, min(k1, ms.k_max))
    kf_mask = torch.zeros((ms.k_max,), dtype=torch.bool, device=row.device)
    kf_mask[top] = top_v > 0
    kf_mask[center_kf] = True
    mp_mask = (kf_mask.float() @ inc) > 0
    mp_mask = mp_mask & ms.mp_valid
    nc = min(n_cand, ms.m_max)
    pos = torch.cumsum(mp_mask.long(), dim=0) - 1
    tgt = torch.where(mp_mask & (pos < nc), pos, nc)
    first_unset = torch.argmin(mp_mask.to(torch.int8))
    cand = first_unset.expand(nc + 1).clone()
    cand[tgt] = torch.arange(ms.m_max, device=row.device)
    return kf_mask, mp_mask, cand[:nc]


# ---------------------------------------------------------------------------
# Culling
# ---------------------------------------------------------------------------

def cull_map_points(ms: MapState, min_found_ratio: float = 0.25,
                    min_obs: int = 2, incidence=None) -> MapState:
    """MapPointCulling: recent points (within 3 KFs of their birth) die on a
    found ratio < 0.25, or on too few observations once 2 KFs old."""
    age = ms.kf_counter - ms.mp_birth_seq
    recent = age <= 3
    n_obs = mp_observation_count(ms, incidence=incidence)
    ratio = ms.mp_found / torch.clamp_min(ms.mp_visible, 1.0)
    bad = ms.mp_valid & recent & ((ratio < min_found_ratio)
                                  | ((age >= 2) & (n_obs < min_obs)))
    new_valid = ms.mp_valid & ~bad
    obs = ms.kf_obs_mp
    dead_ref = (obs >= 0) & ~new_valid[torch.clamp_min(obs, 0).long()]
    return ms._replace(mp_valid=new_valid,
                       kf_obs_mp=torch.where(dead_ref, NO_MP, obs))


def erase_keyframe(ms: MapState, slot) -> MapState:
    """KeyFrame::SetBadFlag: free the slot, detach its observations."""
    return ms._replace(
        kf_valid=_set_row(ms.kf_valid, slot, False),
        kf_obs_mp=_set_row(ms.kf_obs_mp, slot, NO_MP),
        kf_kp_valid=_set_row(ms.kf_kp_valid, slot, False),
        kf_prev=torch.where(ms.kf_prev == slot, ms.kf_prev[slot], ms.kf_prev),
    )


def create_new_map(ms: MapState) -> MapState:
    """Tracking::CreateMapInAtlas: the current map goes dormant."""
    return ms._replace(
        active_map=ms.n_maps.clone(),
        n_maps=ms.n_maps + 1,
        imu_initialized=torch.zeros_like(ms.imu_initialized),
        viba1_done=torch.zeros_like(ms.viba1_done),
        viba2_done=torch.zeros_like(ms.viba2_done),
    )


def merge_maps(ms: MapState, from_map, into_map, s, rot, t) -> MapState:
    """Relabel `from_map` into `into_map`, applying the world Sim3
    X' = s R X + t to its KFs and MPs (LoopClosing::MergeLocal essence);
    `into_map` becomes the active map."""
    kf_sel = ms.kf_valid & (ms.kf_map_id == from_map)
    mp_sel = ms.mp_valid & (ms.mp_map_id == from_map)
    # Tcw' = Tcw S^-1: R_cw' = R_cw R^T, t_cw' = s t_cw - R_cw R^T t
    new_rot = torch.einsum("kij,lj->kil", ms.kf_rot, rot)
    new_t = s * ms.kf_t - torch.einsum("kij,j->ki", new_rot, t)
    new_pos = s * ms.mp_pos @ rot.T + t
    into = torch.as_tensor(into_map, dtype=torch.int32,
                           device=ms.kf_map_id.device)
    return ms._replace(
        kf_rot=torch.where(kf_sel[:, None, None], new_rot, ms.kf_rot),
        kf_t=torch.where(kf_sel[:, None], new_t, ms.kf_t),
        kf_map_id=torch.where(kf_sel, into, ms.kf_map_id),
        mp_pos=torch.where(mp_sel[:, None], new_pos, ms.mp_pos),
        mp_map_id=torch.where(mp_sel, into, ms.mp_map_id),
        active_map=into.clone(),
    )
