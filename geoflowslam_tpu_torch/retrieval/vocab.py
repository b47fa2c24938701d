"""Bag-of-binary-words vocabulary (port of geoflowslam_tpu/retrieval/vocab.py).

A complete k-ary tree of depth L over 256-bit ORB descriptors: `descend` is
a per-level batched Hamming argmin over each keypoint's k children, BoW
vectors are dense [V] tf-idf histograms, and `l1_score` is DBoW2's L1
similarity. Centres are [k^(l+1), 8] int32 tensors holding the reference's
uint32 words bit for bit.

torch has no popcount: `hamming_batch` counts bits with a SWAR reduction on
int64 words masked to 32 bits (an arithmetic right shift of a negative
int32 would drag the sign bit in).

The shipped vocabulary is the port's own asset
(geoflowslam_tpu_torch/assets/vocab_default.npz, a byte-for-byte copy of the
reference's), read with numpy. `build_vocabulary` is the reference's numpy
hierarchical k-medians, for tests and for scenes the shipped vocabulary
does not cover.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

DEFAULT_VOCAB_PATH = (Path(__file__).resolve().parents[1] / "assets"
                      / "vocab_default.npz")


class Vocabulary(NamedTuple):
    """Complete k-ary tree of depth L; node centres stored per level."""
    centers: tuple          # per level l: [k^(l+1), 8] int32 node centres
    weights: torch.Tensor   # [V] idf word weights
    k: int
    levels: int

    @property
    def n_words(self):
        return self.k ** self.levels

    def to(self, device) -> "Vocabulary":
        return self._replace(centers=tuple(c.to(device) for c in self.centers),
                             weights=self.weights.to(device))


def _from_numpy(centers, weights, k: int, levels: int,
                device) -> Vocabulary:
    cs = tuple(torch.from_numpy(np.ascontiguousarray(
        np.asarray(c, np.uint32)).view(np.int32).copy()).to(device)
        for c in centers)
    return Vocabulary(centers=cs, weights=torch.from_numpy(
        np.asarray(weights, np.float32).copy()).to(device),
        k=int(k), levels=int(levels))


# ---------------------------------------------------------------------------
# Offline construction (numpy, as the reference's)
# ---------------------------------------------------------------------------

def _popcount_np(x):
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8),
                         axis=-1).sum(-1)


def _majority_center(desc: np.ndarray) -> np.ndarray:
    """Bitwise-majority centroid of [N, 8] uint32 descriptors."""
    bits = np.unpackbits(np.ascontiguousarray(desc).view(np.uint8), axis=-1)
    maj = (bits.mean(axis=0) >= 0.5).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians_binary(desc: np.ndarray, k: int, iters: int, rng) -> np.ndarray:
    """Binary k-means (majority-vote centres, Hamming assignment)."""
    n = len(desc)
    if n == 0:
        return np.zeros((k, 8), np.uint32)
    centers = desc[rng.choice(n, size=min(k, n), replace=False)]
    if len(centers) < k:
        centers = np.concatenate(
            [centers, centers[rng.choice(len(centers), k - len(centers))]])
    for _ in range(iters):
        d = _popcount_np(desc[:, None, :] ^ centers[None, :, :])
        assign = d.argmin(axis=1)
        for c in range(k):
            sel = desc[assign == c]
            if len(sel):
                centers[c] = _majority_center(sel)
    return centers.astype(np.uint32)


def build_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 3,
                     iters: int = 6, seed: int = 0, *,
                     device) -> Vocabulary:
    """Hierarchical k-medians over [N, 8] descriptor words (uint32 or int32
    with the same bits), host-side and offline like DBoW2's create()."""
    rng = np.random.RandomState(seed)
    desc = np.ascontiguousarray(np.asarray(descriptors)).view(np.uint32)
    level_centers = []
    assign = np.zeros(len(desc), np.int64)
    n_nodes = 1
    for _ in range(levels):
        centers = np.zeros((n_nodes * k, 8), np.uint32)
        new_assign = np.zeros_like(assign)
        for node in range(n_nodes):
            sel = assign == node
            c = _kmedians_binary(desc[sel], k, iters, rng)
            centers[node * k:(node + 1) * k] = c
            if sel.any():
                d = _popcount_np(desc[sel][:, None, :] ^ c[None, :, :])
                new_assign[sel] = node * k + d.argmin(axis=1)
        level_centers.append(centers)
        assign = new_assign
        n_nodes *= k
    counts = np.bincount(assign, minlength=n_nodes).astype(np.float64)
    n_im = max(len(desc) / 500.0, 1.0)  # pseudo-documents
    idf = np.log(n_im / np.maximum(counts / 500.0, 1e-3))
    idf = np.maximum(idf, 0.0) + 1e-3
    return _from_numpy(level_centers, idf, k, levels, device)


def load_vocabulary(path, device) -> Vocabulary:
    """Read a vocabulary npz (the reference's save_vocabulary format)."""
    with np.load(path) as z:
        levels = int(z["levels"])
        return _from_numpy([z[f"centers_{i}"] for i in range(levels)],
                           z["weights"], int(z["k"]), levels, device)


_DEFAULT: dict = {}


def default_vocabulary(device) -> Vocabulary:
    """The shipped vocabulary (k = 10, 4 levels, 10 000 words), cached per
    device."""
    key = str(torch.device(device))
    if key not in _DEFAULT:
        _DEFAULT[key] = load_vocabulary(DEFAULT_VOCAB_PATH, device)
    return _DEFAULT[key]


# ---------------------------------------------------------------------------
# Descent and scoring
# ---------------------------------------------------------------------------

def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each 32-bit word of an integer tensor, as int64."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_batch(desc: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[N, 8] vs [N, k, 8] -> [N, k] int32 Hamming distances."""
    return popcount32(desc[:, None, :] ^ centers).sum(-1).to(torch.int32)


def descend(vocab: Vocabulary, desc: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """[N, 8] descriptors -> word ids [N] int32 (-1 where invalid), the
    nearest child at each level, ties to the lowest child."""
    n = desc.shape[0]
    node = torch.zeros((n,), dtype=torch.long, device=desc.device)
    kids = torch.arange(vocab.k, device=desc.device)
    for lvl in range(vocab.levels):
        child_ids = node[:, None] * vocab.k + kids[None, :]
        d = hamming_batch(desc, vocab.centers[lvl][child_ids])
        node = node * vocab.k + torch.argmin(d, dim=1)
    return torch.where(valid, node, -1).to(torch.int32)


def bow_vector(vocab: Vocabulary, word_ids: torch.Tensor) -> torch.Tensor:
    """Dense tf-idf L1-normalised BoW vector [V]."""
    v = vocab.n_words
    tgt = torch.where(word_ids >= 0, word_ids.long(), v)
    hist = torch.zeros((v + 1,), dtype=torch.float32,
                       device=word_ids.device).index_add_(
        0, tgt, torch.ones(tgt.shape, dtype=torch.float32,
                           device=word_ids.device))[:v]
    w = hist * vocab.weights
    return w / torch.clamp_min(torch.sum(w), 1e-9)


def l1_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of L1-normalised vectors, sum min(a_i, b_i);
    batched over `a`'s leading dims."""
    return torch.sum(torch.minimum(a, b), dim=-1)
