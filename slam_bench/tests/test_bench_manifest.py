"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "slam_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["slam_bench"]
    assert MANIFEST["command"] == ["python3", "slam_bench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    seen = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[kind]:
            assert NAME.match(e["name"]), e["name"]
            assert (kind, e["name"]) not in seen
            seen.add((kind, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("cfg", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file_found(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("slam_bench/")
    body = json.loads(path.read_text())
    assert body["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert set(body["reduced"]) == set(cfg["reduced"])
    assert "assumed" in body and "system" in body


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_cell_files_found(cell):
    from slam_bench import cell as C
    from slam_bench.check import load_probe
    spec = C.find_cell(MANIFEST, cell["name"])
    assert spec.cell == cell
    assert {"trajectory", "warmup", "fps", "max_window_fps"} <= set(
        spec.traffic)
    assert {"attr", "at_least", "min_frames", "max_frames"} <= set(
        spec.traffic["warmup"])
    assert spec.config["entry"].startswith("track_")
    assert spec.limits and all(v >= 0 for v in spec.limits.values())
    named = set()
    for name in spec.probes:
        mod = load_probe(name)
        assert callable(mod.keep) and callable(mod.numbers)
        named |= set(mod.NUMBERS)
    assert set(spec.limits) <= named
    e2e = C.cell_metrics(MANIFEST, cell["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert C.cell_metrics(MANIFEST, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_reader_found(metric):
    from slam_bench import cell as C
    assert callable(C.load_reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


@pytest.mark.parametrize("path", sorted((BENCH / "metrics").glob("*.py")),
                         ids=lambda p: p.stem)
def test_every_reader_loads(path):
    """Readers kept for a cell that is not listed yet load too."""
    from slam_bench import cell as C
    assert callable(C.load_reader(path.stem))
