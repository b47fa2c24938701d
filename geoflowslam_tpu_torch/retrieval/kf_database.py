"""Keyframe database: BoW store and loop/relocalization candidate retrieval
(port of geoflowslam_tpu/retrieval/kf_database.py).

KeyFrameDatabase's inverted file becomes a dense [K_MAX, V] BoW matrix next
to the MapState; DetectNBestCandidates and DetectRelocalizationCandidates
become masked batched L1-score reductions over it. Every top-k breaks ties
by the lowest index, as jax.lax.top_k does (ops/indexing.topk_stable).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from geoflowslam_tpu_torch.ops.indexing import topk_stable
from geoflowslam_tpu_torch.retrieval import vocab as V
from geoflowslam_tpu_torch.state import map_state as M


class KFDatabase(NamedTuple):
    bow: torch.Tensor     # [K_MAX, V] L1-normalised tf-idf vectors
    valid: torch.Tensor   # [K_MAX] bool

    @staticmethod
    def create(k_max: int, n_words: int, device) -> "KFDatabase":
        return KFDatabase(
            bow=torch.zeros((k_max, n_words), dtype=torch.float32,
                            device=device),
            valid=torch.zeros((k_max,), dtype=torch.bool, device=device))


def set_entry(db: KFDatabase, slot, vec: torch.Tensor) -> KFDatabase:
    return KFDatabase(bow=M._set_row(db.bow, slot, vec),
                      valid=M._set_row(db.valid, slot, True))


def add_keyframe(db: KFDatabase, vocab: V.Vocabulary, slot,
                 desc: torch.Tensor, kp_valid: torch.Tensor) -> KFDatabase:
    words = V.descend(vocab, desc, kp_valid)
    return set_entry(db, slot, V.bow_vector(vocab, words))


def erase_keyframe(db: KFDatabase, slot) -> KFDatabase:
    return db._replace(valid=M._set_row(db.valid, slot, False))


def detect_candidates(db: KFDatabase, ms: M.MapState, query_vec: torch.Tensor,
                      query_kf, n_best: int = 3, exclude_window: int = 10,
                      group_size: int = 10, cov=None):
    """Loop/merge candidates for `query_kf` with covisibility-group scoring
    (KeyFrameDatabase::DetectNBestCandidates): a candidate's score is summed
    over its group (itself + its top-`group_size` covisible KFs), ranking by
    the group sum and returning the group's best-scoring member. KFs
    connected to the query, and KFs of the same map within 3 s of it, are
    excluded; dormant Atlas maps are always eligible (the merge path).

    Returns (cand_idx [n_best], cand_score [n_best], cand_ok [n_best])."""
    k = ms.k_max
    dev = db.bow.device
    scores = V.l1_score(db.bow, query_vec[None, :])            # [K]
    if cov is None:
        cov = M.covisibility(ms)
    connected = cov[query_kf] > 0
    mask = db.valid & ms.kf_valid & ~connected
    mask = M._set_row(mask, query_kf, False)
    dt = torch.abs(ms.kf_time - ms.kf_time[query_kf])
    same_map = ms.kf_map_id == ms.kf_map_id[query_kf]
    mask = mask & ~(same_map & (dt < 3.0))
    s = torch.where(mask, scores, 0.0)

    g = min(group_size, k)
    nb_w, nb_idx = topk_stable(cov, g)                         # [K, g]
    member_s = s[nb_idx] * (nb_w > 0)                          # [K, g]
    acc = s + torch.sum(member_s, dim=1)
    g_scores = torch.cat([s[:, None], member_s], dim=1)        # [K, g+1]
    g_idx = torch.cat([torch.arange(k, device=dev)[:, None], nb_idx], dim=1)
    best_loc = torch.argmax(g_scores, dim=1)
    best_member = torch.gather(g_idx, 1, best_loc[:, None])[:, 0]
    best_member_s = torch.gather(g_scores, 1, best_loc[:, None])[:, 0]

    acc = torch.where(mask, acc, -1.0)
    vals, idx = topk_stable(acc, n_best)
    cand = best_member[idx].to(torch.int32)
    cand_s = best_member_s[idx]
    return cand, cand_s, (vals > 0.0) & (cand_s > 0.0)


def detect_relocalization_candidates(db: KFDatabase, ms: M.MapState,
                                     query_vec: torch.Tensor,
                                     n_best: int = 5):
    """Relocalization candidates: the best-scoring valid KFs of the ACTIVE
    map (DetectRelocalizationCandidates filters to the active Map).
    Returns (idx [n_best], score [n_best], ok [n_best])."""
    scores = V.l1_score(db.bow, query_vec[None, :])
    active = ms.kf_map_id == ms.active_map
    s = torch.where(db.valid & ms.kf_valid & active, scores, -1.0)
    vals, idx = topk_stable(s, n_best)
    return idx, vals, vals > 0.0
