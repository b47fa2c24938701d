"""Run one cell of the benchmark once and print its result line.

    python3 slam_bench/run.py --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout holding the benchmark (BENCHMARK.json,
slam_bench/) and geoflowslam_tpu_torch, on a machine with the CUDA cards
the cell asks for. Standard error ends with each number that decided
`correct` beside its limit; the last line of standard output is the JSON
result. Without a CUDA card, or with fewer than the cell's chips, it exits
with code 3 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "slam_bench_cache"     # fixed, inside the checkout
THREADS = 2


def setup_env() -> None:
    """Every build and kernel cache in fixed directories of the checkout;
    few host threads; no JAX from any library."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a non-negative integer")
    setup_env()
    from slam_bench import cell as C
    manifest = C.load_manifest()
    chips = next((w["chips"] for w in manifest["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card, or fewer than {chips}: "
              f"is_available={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(THREADS)
    out = C.run_cell(C.find_cell(manifest, args.workload), args.seed,
                     args.seconds, bool(args.trace), T_START)
    report(out)
    return 0


def report(out: dict) -> None:
    """Earlier lines on standard error, the compared numbers last; the
    result line last on standard output."""
    for k, v in out["info"].items():
        print(f"[run] {k}: {v}", file=sys.stderr)
    for name, value, limit in out["rows"]:
        print(f"[check] {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)


if __name__ == "__main__":
    sys.exit(main())
