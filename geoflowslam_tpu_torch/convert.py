"""Conversion of the JAX package's state into the port's tensors.

The inputs are the reference's NamedTuples (FeatureSet, FrameData,
MapState, TrackResult, Vocabulary, KFDatabase) or anything else with the
same fields whose leaves numpy can read; nothing here imports the JAX
package. Descriptor words (uint32 in the reference) become int32 tensors
holding the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from geoflowslam_tpu_torch.ops.extractor import FeatureSet
from geoflowslam_tpu_torch.pipeline.tracking import TrackResult
from geoflowslam_tpu_torch.retrieval.kf_database import KFDatabase
from geoflowslam_tpu_torch.retrieval.vocab import Vocabulary
from geoflowslam_tpu_torch.state.frame import FrameData
from geoflowslam_tpu_torch.state.map_state import MapState


def to_tensor(x, device) -> torch.Tensor:
    """numpy-readable array -> tensor on `device`; uint32 words become
    int32 with the same bits."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(cls, obj, device):
    get = (obj.__getitem__ if isinstance(obj, dict)
           else lambda f: getattr(obj, f))
    return cls(**{f: to_tensor(get(f), device) for f in cls._fields})


def feature_set(fs, device) -> FeatureSet:
    return _convert(FeatureSet, fs, device)


def frame_data(fd, device) -> FrameData:
    return FrameData(
        feat=feature_set(fd.feat, device),
        depth_kp=to_tensor(fd.depth_kp, device),
        u_right=to_tensor(fd.u_right, device),
        cloud=to_tensor(fd.cloud, device),
        cloud_valid=to_tensor(fd.cloud_valid, device),
        lk_pyramid=tuple(to_tensor(x, device) for x in fd.lk_pyramid),
        depth_img=(None if getattr(fd, "depth_img", None) is None
                   else to_tensor(fd.depth_img, device)))


def map_state(ms, device) -> MapState:
    return _convert(MapState, ms, device)


def track_result(tr, device) -> TrackResult:
    return _convert(TrackResult, tr, device)


def vocabulary(voc, device) -> Vocabulary:
    return Vocabulary(centers=tuple(to_tensor(c, device)
                                    for c in voc.centers),
                      weights=to_tensor(voc.weights, device),
                      k=int(voc.k), levels=int(voc.levels))


def kf_database(db, device) -> KFDatabase:
    return _convert(KFDatabase, db, device)
