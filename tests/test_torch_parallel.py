"""The port's landmark-sharded global BA (geoflowslam_tpu_torch/parallel/
dist_ba.py, local_mapping.global_ba_step_distributed and the dry run's
production map) against the JAX package's on its 8-device virtual CPU mesh
(tests/conftest.py), on the CPU; with the host pieces of the same slice:
the DBoW2 text vocabulary, save_vocabulary and the synthetic time warp.

Tolerances: the 8-shard step within 1e-4 m (KF translations, landmarks)
and 1e-5 rad (KF rotations) of JAX's 8-device step, after 5 and 12
iterations (float32 on both sides, the partial systems summed in another
order); 8 shards against 1 shard of the port within 1e-4 m (JAX's own
bound, tests/test_parallel.py:68); the populated map's global BA within
1e-4 m. The DBoW2 loader and the npz round trip are exact; the time-warped
trajectory within 1e-5 (float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.parallel import dist_ba as JD
from geoflowslam_tpu.pipeline import local_mapping as JLM
from geoflowslam_tpu.retrieval import vocab as JV
import __graft_entry__ as G
from test_parallel import FX, CX, CY, make_problem

from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.config import MappingConfig
from geoflowslam_tpu_torch.io import synthetic as TS
from geoflowslam_tpu_torch.parallel import dist_ba as TD
from geoflowslam_tpu_torch.pipeline import local_mapping as TLM
from geoflowslam_tpu_torch.retrieval import vocab as TV
from geoflowslam_tpu_torch.solvers.local_ba import BAProblem
from geoflowslam_tpu_torch.tools import dryrun_multichip as DR

torch.set_num_threads(2)


def _jax_mesh(n=8):
    devs = jax.devices()
    assert len(devs) >= n, devs
    return Mesh(np.array(devs[:n]), axis_names=("land",))


def _to_torch(prob) -> BAProblem:
    return BAProblem(**{f: torch.from_numpy(np.array(getattr(prob, f)))
                        for f in BAProblem._fields})


def _rot_err(ra, rb):
    """Largest angle (rad) of ra^T rb over the batch, from its skew part
    (arccos of the trace loses small angles to float32 rounding)."""
    d = np.einsum("kji,kjl->kil", np.asarray(ra, np.float64),
                  np.asarray(rb, np.float64))
    w = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0],
                  d[:, 1, 0] - d[:, 0, 1]], axis=1) / 2.0
    return float(np.max(np.arcsin(np.clip(np.linalg.norm(w, axis=1), 0, 1))))


@pytest.fixture(scope="module")
def problem():
    prob, *_ = make_problem(jax.random.PRNGKey(1))
    return prob


@pytest.mark.parametrize("iters", [5, 12])
def test_distributed_ba_matches_jax_8dev(problem, iters):
    ref = JD.make_distributed_ba(_jax_mesh(), FX, FX, CX, CY,
                                 iters=iters)(problem)
    out = TD.make_distributed_ba(TD.LandMesh(["cpu"] * 8), FX, FX, CX, CY,
                                 iters=iters)(_to_torch(problem))
    np.testing.assert_allclose(out.kf_t.numpy(), np.asarray(ref.kf_t),
                               atol=1e-4)
    np.testing.assert_allclose(out.pts.numpy(), np.asarray(ref.pts),
                               atol=1e-4)
    assert _rot_err(out.kf_rot.numpy(), ref.kf_rot) < 1e-5
    # the fixed KFs stay where they were
    np.testing.assert_array_equal(out.kf_t[:2].numpy(),
                                  np.asarray(problem.kf_t[:2]))


def test_eight_shards_match_one_shard(problem):
    prob = _to_torch(problem)
    outs = [TD.make_distributed_ba(TD.LandMesh(["cpu"] * n), FX, FX, CX, CY,
                                   iters=5)(prob) for n in (1, 8)]
    np.testing.assert_allclose(outs[0].kf_t.numpy(), outs[1].kf_t.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(outs[0].pts.numpy(), outs[1].pts.numpy(),
                               atol=1e-4)
    # a shard's slice is its own: the shards joined back are the problem
    shards = TD.shard(prob, TD.LandMesh(["cpu"] * 8))
    assert all(s.pts.shape[0] == 32 and s.uv.shape[1] == 32 for s in shards)
    back = TD.gather(shards, "cpu")
    for f in BAProblem._fields:
        assert torch.equal(getattr(back, f), getattr(prob, f)), f


def test_indivisible_landmarks_raise(problem):
    fn = TD.make_distributed_ba(TD.LandMesh(["cpu"] * 3), FX, FX, CX, CY)
    with pytest.raises(ValueError, match="not divisible"):
        fn(_to_torch(problem))
    with pytest.raises(ValueError):
        TD.LandMesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TD.LandMesh(["cuda:0"] * 2)


def _jax_populated_map():
    """tests/test_parallel.py:71-103's map: three KFs observing 128 shared
    points, the points stored 2 cm off."""
    from geoflowslam_tpu.state import map_state as JM
    ms = JM.create(8, 128, 1024)
    pts = jax.random.uniform(jax.random.PRNGKey(0), (128, 3),
                             minval=jnp.array([-2, -2, 3.0]),
                             maxval=jnp.array([2, 2, 8.0]))
    for slot, tx in [(0, 0.0), (1, -0.3), (2, -0.6)]:
        t = jnp.array([tx, 0, 0])
        pc = pts + t
        uv = pc[:, :2] / pc[:, 2:3] * 400.0 + jnp.array([320.0, 240.0])
        ms = JM.insert_keyframe(
            ms, jnp.int32(slot), jnp.eye(3), t, jnp.zeros(3), jnp.zeros(6),
            jnp.float32(slot * 1.0), uv, jnp.zeros(128, jnp.int32),
            jnp.zeros(128), jnp.ones((128, 8), jnp.uint32),
            jnp.full((128,), -1.0), jnp.ones(128, bool),
            jnp.arange(128, dtype=jnp.int32), jnp.int32(slot - 1))
    ms = JM.add_map_points(ms, jnp.arange(128, dtype=jnp.int32), pts + 0.02,
                           jnp.ones((128, 8), jnp.uint32), jnp.zeros((128, 3)),
                           jnp.zeros(128), jnp.full((128,), 100.0),
                           jnp.int32(0), jnp.ones(128, bool))
    return ms, np.asarray(pts)


def test_global_ba_step_distributed_matches_jax():
    jms, pts = _jax_populated_map()
    ref = JLM.global_ba_step_distributed(jms, JLM.MappingConfig(),
                                         _jax_mesh(), ba_pts=256, iters=6)
    out = TLM.global_ba_step_distributed(
        convert.map_state(jms, "cpu"), MappingConfig(),
        TD.LandMesh(["cpu"] * 8), ba_pts=256, iters=6)
    np.testing.assert_allclose(out.mp_pos.numpy(), np.asarray(ref.mp_pos),
                               atol=1e-4)
    np.testing.assert_allclose(out.kf_t.numpy(), np.asarray(ref.kf_t),
                               atol=1e-4)
    np.testing.assert_array_equal(out.kf_obs_mp.numpy(),
                                  np.asarray(ref.kf_obs_mp))
    err = np.linalg.norm(out.mp_pos[:128].numpy() - pts, axis=1)
    assert np.median(err) < 0.01, np.median(err)


DRY = dict(k_used=24, n_kp=96, n_pts=512, m_max=1024, k_max=24)


def test_dryrun_map_matches_jax_reduced():
    """The dry run's production map at a reduced size (24 KFs x 96
    observations of 512 landmarks): the port's populated_map on JAX's
    points and descriptors gives JAX's map, and 2 sharded iterations agree
    within 1e-4 m; the port's own gate (median error < 2 cm) holds."""
    jms, jpts = G._populated_production_map(**DRY)
    ms, pts = DR.populated_map("cpu", **DRY, pts=np.asarray(jpts),
                               desc=np.asarray(jms.mp_desc[:512]).view(
                                   np.int32))
    conv = convert.map_state(jms, "cpu")
    for f in ("kf_rot", "kf_t", "kf_uv", "kf_obs_mp", "kf_desc", "kf_valid",
              "kf_prev", "kf_time", "mp_pos", "mp_valid", "mp_desc"):
        assert torch.allclose(getattr(ms, f).float(),
                              getattr(conv, f).float(), atol=1e-5), f
    ref = JLM.global_ba_step_distributed(jms, JLM.MappingConfig(),
                                         _jax_mesh(), ba_pts=512, iters=2)
    out = TLM.global_ba_step_distributed(ms, MappingConfig(),
                                         TD.LandMesh(["cpu"] * 8),
                                         ba_pts=512, iters=2)
    np.testing.assert_allclose(out.mp_pos.numpy(), np.asarray(ref.mp_pos),
                               atol=1e-4)
    np.testing.assert_allclose(out.kf_t.numpy(), np.asarray(ref.kf_t),
                               atol=1e-4)
    ms2, pts2 = DR.populated_map("cpu", **DRY)
    assert DR.check_gate(ms2, pts2, DR.mesh_of(4, ["cpu"]), 512) < 0.02
    assert TD.reduced_bytes(24, DR.mesh_of(4, ["cpu"])) == 4 * (
        36 * 24 * 24 + 6 * 24) * 4


@pytest.mark.slow
def test_dryrun_production_against_jax_reading():
    """The dry run at production shapes (256 KFs x 512 observations of 4096
    landmarks, m_max 16384, ba_pts 4096) on four shards in both packages:
    JAX's median landmark error after 2 iterations is the reading that
    dryrun_multichip.REFERENCE_MEDIAN_ERR records (the card's mesh_gba
    gate; 1e-6 m: its 4- and 1-device runs part by 1.1e-7), and the
    port's is within REFERENCE_ERR_TOL of it (~1.2 GiB, ~1 min)."""
    jms, jpts = G._populated_production_map()
    ref = JLM.global_ba_step_distributed(jms, JLM.MappingConfig(),
                                         _jax_mesh(4), ba_pts=4096, iters=2)
    jerr = float(np.median(np.linalg.norm(
        np.asarray(ref.mp_pos[:4096]) - np.asarray(jpts), axis=1)))
    ms, pts = DR.populated_map("cpu", pts=DR.reference_landmarks())
    err = DR.check_gate(ms, pts, DR.mesh_of(4, ["cpu"]),
                        reference=DR.REFERENCE_MEDIAN_ERR)
    print(f"median landmark error after 2 iterations: JAX {jerr:.9f} m, "
          f"port {err:.9f} m")
    assert abs(jerr - DR.REFERENCE_MEDIAN_ERR) < 1e-6, jerr


def test_reference_landmarks_are_the_jax_draw():
    """The dry run's landmark asset is the JAX dry run's own draw."""
    _, jpts = G._populated_production_map(k_used=2, n_kp=8, n_pts=4096,
                                          m_max=4096, k_max=2)
    np.testing.assert_array_equal(DR.reference_landmarks(), np.asarray(jpts))


def _write_dbow2(path):
    """A small DBoW2 text tree, k 3, L 2: root children 1-3 (node 3 a
    leaf), node 1 with three children, node 2 with one; weights on every
    node."""
    rng = np.random.RandomState(3)
    rows = []           # (parent, is_leaf)
    rows += [(0, 0), (0, 0), (0, 1)]              # ids 1, 2, 3
    rows += [(1, 1), (1, 1), (1, 1)]              # ids 4, 5, 6
    rows += [(2, 1)]                              # id 7
    with open(path, "w") as f:
        f.write("3 2 0 0\n")
        for i, (par, leaf) in enumerate(rows):
            d = " ".join(str(x) for x in rng.randint(0, 256, 32))
            f.write(f"{par} {leaf} {d} {0.5 + 0.25 * i:.6f}\n")
        f.write("bad line\n")


def test_load_dbow2_text_matches_jax(tmp_path):
    p = str(tmp_path / "voc.txt")
    _write_dbow2(p)
    for lv in (None, 1):
        ref = JV.load_dbow2_text(p, max_levels=lv)
        out = TV.load_dbow2_text(p, max_levels=lv, device="cpu")
        assert (out.k, out.levels) == (ref.k, ref.levels)
        for a, b in zip(out.centers, ref.centers):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(b))
        np.testing.assert_array_equal(out.weights.numpy(),
                                      np.asarray(ref.weights))


def test_save_vocabulary_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    desc = rng.randint(0, 2 ** 32, (600, 8), dtype=np.uint64).astype(
        np.uint32)
    voc = TV.build_vocabulary(desc, k=4, levels=2, iters=2, device="cpu")
    p = str(tmp_path / "v.npz")
    TV.save_vocabulary(p, voc)
    back = TV.load_vocabulary(p, "cpu")
    ref = JV.load_vocabulary(p)
    assert (back.k, back.levels) == (voc.k, voc.levels) == (ref.k, ref.levels)
    for a, b, c in zip(voc.centers, back.centers, ref.centers):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(c))
    assert torch.equal(voc.weights, back.weights)
    np.testing.assert_array_equal(voc.weights.numpy(),
                                  np.asarray(ref.weights))
    # the JAX package's own writer is read back the same way
    p2 = str(tmp_path / "j.npz")
    JV.save_vocabulary(p2, ref)
    back2 = TV.load_vocabulary(p2, "cpu")
    for a, b in zip(voc.centers, back2.centers):
        assert torch.equal(a, b)


@pytest.mark.parametrize("freq", [1.0, 1.6])
def test_time_warp_matches_jax(freq):
    ts = np.linspace(0.0, 6.0, 37).astype(np.float32)
    ref = JS.smooth_trajectory(jnp.asarray(ts), 1.2, freq)
    out = TS.smooth_trajectory(torch.from_numpy(ts), 1.2, freq)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    cam = TS.Camera(fx=100.0, fy=100.0, cx=40.0, cy=30.0, width=80,
                    height=60)
    jcam = JS.Camera(fx=100.0, fy=100.0, cx=40.0, cy=30.0, width=80,
                     height=60)
    seq = TS.SyntheticSequence(TS.SyntheticWorld(cam, device="cpu"),
                               scale=1.2, freq=freq)
    jseq = JS.SyntheticSequence(JS.SyntheticWorld(jcam), scale=1.2,
                                freq=freq)
    for a, b in zip(seq.pose_cw(2.5), jseq.pose_cw(2.5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for a, b in zip(seq.imu_between(1.0, 1.1, 24),
                    jseq.imu_between(1.0, 1.1, 24)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
