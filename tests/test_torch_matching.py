"""Port parity of descriptor matching: hamming_matrix, match_descriptors and
search_by_projection (plain gated path) against the JAX package's XLA
branch, exact indices and distances; and the gated best/second/argbest
against a numpy popcount brute force with lowest-index ties."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.ops import matching as JM

from geoflowslam_tpu_torch.ops import matching as TM

torch.set_num_threads(2)


def _inputs(n, m, seed, copy_frac=0.5):
    rs = np.random.RandomState(seed)
    dq = rs.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    dt = rs.randint(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    k = int(min(n, m) * copy_frac)
    dt[:k] = dq[:k]
    # a few near copies and duplicate targets make ratio-test and tie cases
    dt[k:k + 20] = dq[:20] ^ np.uint32(1)
    dt[k + 20:k + 40] = dt[:20]
    uv_q = (rs.rand(n, 2) * 320).astype(np.float32)
    uv_t = np.resize(uv_q, (m, 2)) + (rs.randn(m, 2) * 2).astype(np.float32)
    return dict(
        dq=dq, dt=dt, uv_q=uv_q, uv_t=uv_t.astype(np.float32),
        lq=rs.randint(0, 4, n).astype(np.int32),
        lt=rs.randint(0, 4, m).astype(np.int32),
        vq=rs.rand(n) > 0.1, vt=rs.rand(m) > 0.1,
        radius=(rs.rand(n) * 10 + 2).astype(np.float32))


def T(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def test_hamming_matrix_and_match_descriptors():
    x = _inputs(200, 150, seed=2)
    hj = np.asarray(JM.hamming_matrix(jnp.asarray(x["dq"]), jnp.asarray(x["dt"])))
    ht = TM.hamming_matrix(T(x["dq"]), T(x["dt"])).numpy()
    np.testing.assert_array_equal(hj, ht)
    for mutual in (False, True):
        ij, dj = JM.match_descriptors(
            jnp.asarray(x["dq"]), jnp.asarray(x["vq"]), jnp.asarray(x["dt"]),
            jnp.asarray(x["vt"]), max_dist=JM.TH_HIGH, ratio=0.9,
            mutual=mutual)
        it, dt = TM.match_descriptors(T(x["dq"]), T(x["vq"]), T(x["dt"]),
                                      T(x["vt"]), max_dist=TM.TH_HIGH,
                                      ratio=0.9, mutual=mutual)
        np.testing.assert_array_equal(np.asarray(ij), it.numpy())
        np.testing.assert_array_equal(np.asarray(dj), dt.numpy())


@pytest.mark.parametrize("seed,min_off,max_off", [(0, -1, 1), (1, 0, 1),
                                                  (2, -1, 1)])
def test_search_by_projection_exact(seed, min_off, max_off):
    """N = M = 300: exact match indices and distances vs the XLA branch."""
    x = _inputs(300, 300, seed)
    ij, dj = JM.search_by_projection(
        jnp.asarray(x["uv_q"]), jnp.asarray(x["lq"]), jnp.asarray(x["vq"]),
        jnp.asarray(x["dq"]), jnp.asarray(x["uv_t"]), jnp.asarray(x["lt"]),
        jnp.asarray(x["dt"]), jnp.asarray(x["vt"]), jnp.asarray(x["radius"]),
        max_dist=JM.TH_HIGH, min_off=min_off, max_off=max_off)
    it, dt = TM.search_by_projection(
        T(x["uv_q"]), T(x["lq"]), T(x["vq"]), T(x["dq"]), T(x["uv_t"]),
        T(x["lt"]), T(x["dt"]), T(x["vt"]), T(x["radius"]),
        max_dist=TM.TH_HIGH, min_off=min_off, max_off=max_off)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    assert (it >= 0).sum() > 20


def test_gated_plain_against_bruteforce():
    """best, second and argbest (lowest index on ties), (BIG, BIG, -1) when
    nothing passes: the contract the CUDA kernel is held to on the card."""
    x = _inputs(120, 90, seed=7)
    best, second, idx = TM.gated_hamming_plain(
        T(x["uv_q"]), T(x["lq"]), T(x["vq"]), T(x["dq"]), T(x["radius"]),
        T(x["uv_t"]), T(x["lt"]), T(x["vt"]), T(x["dt"]), -1, 1)
    pop = np.vectorize(lambda v: bin(int(v)).count("1"))
    for i in range(120):
        cands = []
        for j in range(90):
            d = x["uv_q"][i] - x["uv_t"][j]
            ok = (abs(d[0]) <= x["radius"][i] and abs(d[1]) <= x["radius"][i]
                  and -1 <= x["lt"][j] - x["lq"][i] <= 1
                  and x["vq"][i] and x["vt"][j])
            if ok:
                cands.append((int(pop(x["dq"][i] ^ x["dt"][j]).sum()), j))
        cands.sort()
        want = (cands[0][0] if cands else TM.BIG,
                cands[1][0] if len(cands) > 1 else TM.BIG,
                cands[0][1] if cands else -1)
        assert (int(best[i]), int(second[i]), int(idx[i])) == want, i
