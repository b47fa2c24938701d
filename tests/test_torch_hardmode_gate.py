"""Regression gate over the port's hard-mode matrix on the card.

The counterpart of tests/test_hardmode_gate.py for
results_hard_torch/matrix.json, which
geoflowslam_tpu_torch/tools/run_hardmode_matrix.py (or
assemble_hardmode_matrix.py) writes from run_hardmode.py's cells. The
gates are the JAX matrix's own: the per-mode ATE and RPE bounds and the
per-KF mapping cost's flatness as the map grows.

Skips when no matrix of the port is committed (the matrix needs the card).
"""
import json
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATRIX = os.path.join(HERE, "results_hard_torch", "matrix.json")

# the JAX matrix's gates (tests/test_hardmode_gate.py), in meters
ATE_GATE = {
    "rgbd": 3.5, "rgbd_loop": 3.5,
    "rgbd_inertial": 0.40, "rgbd_inertial_loop": 0.10,
    "mono": 0.40, "mono_loop": 0.15,
    "rgbd_of_icp": 1.6, "rgbd_of_icp_loop": 1.6,
}
RPE_GATE_M = {
    "rgbd": 0.60, "rgbd_loop": 0.60,
    "rgbd_of_icp": 0.15, "rgbd_of_icp_loop": 0.15,
}
RPE_GATE_DEFAULT_M = 0.05


def check_cells(cells: dict) -> None:
    """Assert every cell ran and meets its gates."""
    assert cells, "matrix.json is empty"
    for tag, d in cells.items():
        assert "error" not in d, f"{tag} failed: {d}"
        gate = ATE_GATE.get(tag)
        if gate is not None:
            assert d["ate_rmse_m"] < gate, (tag, d["ate_rmse_m"], gate)
        rpe_gate = RPE_GATE_M.get(tag, RPE_GATE_DEFAULT_M)
        assert d["rpe_trans_m"] < rpe_gate, (tag, d["rpe_trans_m"])
        # per-KF mapping cost must stay flat as the map grows (no O(K))
        if d["kf_cost_early_ms"] == d["kf_cost_early_ms"]:  # not NaN
            assert d["kf_cost_late_ms"] < 4.0 * d["kf_cost_early_ms"] + 50, (
                tag, d["kf_cost_early_ms"], d["kf_cost_late_ms"])


@pytest.mark.skipif(not os.path.exists(MATRIX),
                    reason="no hard-mode matrix of the port (needs the card)")
def test_hardmode_matrix_gates():
    with open(MATRIX) as f:
        check_cells({d["tag"]: d for d in json.load(f)})


def test_gates_are_the_jax_matrix_gates():
    """The port's matrix is held to the same bounds as the JAX matrix."""
    import test_hardmode_gate as J
    assert ATE_GATE == J.ATE_GATE
    assert RPE_GATE_M == J.RPE_GATE_M
    assert RPE_GATE_DEFAULT_M == J.RPE_GATE_DEFAULT_M


def test_gate_refuses_a_bad_cell():
    """The check passes the committed single-cell card runs and refuses an
    error row, an ATE past its gate and a per-KF cost that grows."""
    cells = {}
    for tag in ("rgbd", "rgbd_of_icp"):
        with open(os.path.join(HERE, "results_hard_torch", tag,
                               "hardmode.json")) as f:
            cells[tag] = dict(json.load(f), tag=tag)
    check_cells(cells)
    bad = [dict(cells["rgbd"], error=1),
           dict(cells["rgbd"], ate_rmse_m=ATE_GATE["rgbd"] + 0.1),
           dict(cells["rgbd"], kf_cost_late_ms=1e4)]
    for row in bad:
        with pytest.raises(AssertionError):
            check_cells({"rgbd": row})
