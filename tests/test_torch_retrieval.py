"""Port parity of the bag-of-words retrieval against the JAX package, on
inputs made with numpy from a seed:

* the shipped vocabulary read as data: the same bits and weights as the
  reference's default_vocabulary;
* descend exact (word ids), bow_vector and l1_score within 1e-6, on the
  shipped vocabulary with descriptors whose words have the sign bit set;
* build_vocabulary (numpy on both sides) identical;
* the KF database: detect_candidates and detect_relocalization_candidates
  exact, ties included (BoW entries in multiples of 1/8, so every sum is
  exact in any order and equal scores stay equal);
* rotation_consistency exact, with ties between histogram bins.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.ops import matching as JM
from geoflowslam_tpu.retrieval import kf_database as JDB
from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.state import map_state as JMS

from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.ops import matching as TM
from geoflowslam_tpu_torch.retrieval import kf_database as TDB
from geoflowslam_tpu_torch.retrieval import vocab as TV

torch.set_num_threads(2)


def _desc(rs, n):
    return rs.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.copy())


def test_default_vocabulary_is_read_as_data():
    jv = JV.default_vocabulary()
    tv = TV.default_vocabulary("cpu")
    assert (tv.k, tv.levels, tv.n_words) == (jv.k, jv.levels, 10_000)
    for a, b in zip(jv.centers, tv.centers):
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      np.asarray(a))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))
    assert TV.default_vocabulary("cpu") is tv             # cached


def test_popcount32_matches_bit_count():
    rs = np.random.RandomState(0)
    w = np.concatenate([_desc(rs, 64).ravel(),
                        np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)])
    want = np.unpackbits(w.view(np.uint8)).reshape(-1, 32).sum(1)
    got = TV.popcount32(_t(w)).numpy()
    np.testing.assert_array_equal(got, want)


def test_descend_and_bow_on_default_vocabulary():
    jv = JV.default_vocabulary()
    tv = TV.default_vocabulary("cpu")
    rs = np.random.RandomState(1)
    desc = _desc(rs, 400)
    # descriptors near the vocabulary's own words, so the descent has real
    # structure to follow (and some exact ties to the lowest child)
    leaf = np.asarray(jv.centers[-1])
    near = leaf[rs.randint(0, len(leaf), 200)].copy()
    flip = rs.randint(0, 2 ** 32, near.shape, dtype=np.uint64).astype(
        np.uint32) & np.uint32(0x01010101)
    desc[:200] = near ^ flip
    desc[200:210] = desc[:10]
    valid = rs.rand(400) > 0.1
    jw = np.asarray(JV.descend(jv, jnp.asarray(desc), jnp.asarray(valid)))
    tw = TV.descend(tv, _t(desc), _t(valid))
    np.testing.assert_array_equal(tw.numpy(), jw)
    assert (jw[~valid] == -1).all() and len(np.unique(jw[valid])) > 50
    jb = np.asarray(JV.bow_vector(jv, jnp.asarray(jw)))
    tb = TV.bow_vector(tv, tw)
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-6, rtol=0)
    other = np.asarray(JV.bow_vector(jv, jnp.asarray(jw[::-1][:300])))
    both = np.stack([jb, other])
    np.testing.assert_allclose(
        TV.l1_score(torch.from_numpy(both), tb).numpy(),
        np.asarray(JV.l1_score(jnp.asarray(both), jnp.asarray(jb))),
        atol=1e-6, rtol=0)


def test_build_vocabulary_identical():
    rs = np.random.RandomState(2)
    desc = _desc(rs, 300)
    desc[100:150] = desc[:50] ^ np.uint32(3)
    jv = JV.build_vocabulary(desc, k=4, levels=2, iters=2, seed=5)
    tv = TV.build_vocabulary(desc.view(np.int32), k=4, levels=2, iters=2,
                             seed=5, device="cpu")
    for a, b in zip(jv.centers, tv.centers):
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      np.asarray(a))
    np.testing.assert_array_equal(tv.weights.numpy(), np.asarray(jv.weights))
    tc = convert.vocabulary(jv, "cpu")
    for a, b in zip(tc.centers, tv.centers):
        assert torch.equal(a, b)


def _db_scene(seed, k=16, n=48, m=256, v=40):
    """A map of k KF slots whose observations give a covisibility pattern,
    two Atlas maps, KF times 0.5 s apart, and BoW rows in multiples of 1/8
    with duplicated rows (score ties)."""
    rs = np.random.RandomState(seed)
    ms = JMS.create(k, n, m)
    obs = np.full((k, n), -1, np.int32)
    for i in range(k):
        sel = rs.rand(n) < 0.6
        base = (i * 12) % (m - n)
        obs[i, sel] = base + np.arange(n)[sel]
    kf_valid = rs.rand(k) > 0.15
    ms = ms._replace(
        kf_obs_mp=jnp.asarray(obs), kf_valid=jnp.asarray(kf_valid),
        kf_kp_valid=jnp.asarray(obs >= 0),
        kf_time=jnp.asarray(np.arange(k, dtype=np.float32) * 0.5),
        kf_map_id=jnp.asarray((np.arange(k) >= k // 2).astype(np.int32)),
        mp_valid=jnp.ones((m,), bool),
        active_map=jnp.int32(1), n_maps=jnp.int32(2))
    bow = np.zeros((k, v), np.float32)
    for i in range(k):
        words = rs.choice(v, 4, replace=False)
        bow[i, words] = np.array([3, 2, 2, 1]) / 8.0
    bow[5] = bow[2]
    bow[11] = bow[2]
    bow[12] = bow[3]
    db_valid = kf_valid & (rs.rand(k) > 0.1)
    q = bow[2].copy()
    return ms, JDB.KFDatabase(bow=jnp.asarray(bow),
                              valid=jnp.asarray(db_valid)), q


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kf_database_candidates_exact(seed):
    ms, jdb, q = _db_scene(seed)
    tms = convert.map_state(ms, "cpu")
    tdb = convert.kf_database(jdb, "cpu")
    for query_kf, n_best in ((15, 3), (9, 5), (0, 3)):
        want = JDB.detect_candidates(jdb, ms, jnp.asarray(q), query_kf,
                                     n_best=n_best)
        got = TDB.detect_candidates(tdb, tms, torch.from_numpy(q), query_kf,
                                    n_best=n_best)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    want = JDB.detect_relocalization_candidates(jdb, ms, jnp.asarray(q),
                                                n_best=5)
    got = TDB.detect_relocalization_candidates(tdb, tms, torch.from_numpy(q),
                                               n_best=5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # add and erase keep the same rows
    rs = np.random.RandomState(seed)
    jv = JV.build_vocabulary(_desc(rs, 200), k=4, levels=2, iters=1)
    tv = convert.vocabulary(jv, "cpu")
    big = JDB.KFDatabase.create(16, jv.n_words)
    desc, kpv = _desc(rs, 48), rs.rand(48) > 0.2
    jdb2 = JDB.erase_keyframe(JDB.add_keyframe(big, jv, 4, jnp.asarray(desc),
                                               jnp.asarray(kpv)), 1)
    tdb2 = TDB.erase_keyframe(TDB.add_keyframe(
        convert.kf_database(big, "cpu"), tv, 4, _t(desc), _t(kpv)), 1)
    np.testing.assert_allclose(tdb2.bow.numpy(), np.asarray(jdb2.bow),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tdb2.valid.numpy(), np.asarray(jdb2.valid))


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_consistency_exact(seed):
    rs = np.random.RandomState(seed)
    n, m = 300, 260
    ang_b = (rs.rand(m) * 2 * np.pi).astype(np.float32)
    match = np.where(rs.rand(n) < 0.8, rs.randint(0, m, n), -1).astype(
        np.int32)
    # three dominant rotations of equal support (bin ties), plus noise
    rot = np.choose(rs.randint(0, 3, n), [0.3, 2.0, 4.1]).astype(np.float32)
    ang_a = (ang_b[np.maximum(match, 0)] + rot).astype(np.float32)
    noisy = rs.rand(n) < 0.3
    ang_a[noisy] = (rs.rand(noisy.sum()) * 2 * np.pi).astype(np.float32)
    want = np.asarray(JM.rotation_consistency(
        jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(match)))
    got = TM.rotation_consistency(_t(ang_a), _t(ang_b), _t(match))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want >= 0).sum() < (match >= 0).sum()
