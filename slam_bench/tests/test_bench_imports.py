"""Nothing the benchmark runs loads JAX or the JAX package: every module of
slam_bench/ read for its imports (top-level names compared whole), and a
fresh process that imports all of it and the port's modules it drives."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "slam_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "geoflowslam_tpu", "chip_smoke",
             "bench"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_source_imports(path):
    names = imported_top_names(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.parts or path.parent.name == "gen":
        assert "geoflowslam_tpu_torch" not in names


def test_top_level_names_compared_whole():
    from slam_bench import cell as C
    assert "geoflowslam_tpu_torch" not in C.FORBIDDEN
    assert "geoflowslam_tpu" in C.FORBIDDEN


def test_fresh_process_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from slam_bench import cell, check, control, run, trace, roofline\n"
        "from slam_bench.gen import room, traffic\n"
        "from slam_bench.reference import features, klt, search, trajectory\n"
        "import json, pathlib\n"
        "m = json.load(open(%r))\n"
        "[cell.load_reader(x['name']) for x in m['per_layer']]\n"
        "from geoflowslam_tpu_torch.pipeline.system import SlamSystem\n"
        "names = [p.stem for p in (cell.BENCH / 'probes').glob('*.py')]\n"
        "p = check.Probe(names, set()); p.install(); p.remove()\n"
        "print(cell.forbidden_modules())\n") % (str(ROOT),
                                               str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
