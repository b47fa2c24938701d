"""The readings that the check's limits are set from: on each seed, the
cell as a run makes it, with the numbers of the plain references (a sound
run's reading, the lower one) and of the bfloat16 references put in the
program's place (the control's reading, the upper one). Not part of a
benchmark run.

    python3 slam_bench/control.py --workload <name> --seconds <s> \
        --seeds <n>,<n>,... [--out <file.jsonl>]

Every seed runs in this one process after one kernel build; one JSON line
a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slam_bench.run import setup_env   # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    setup_env()
    import torch
    from slam_bench import cell as C
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    spec = C.find_cell(C.load_manifest(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = C.run_cell(spec, seed, args.seconds, False,
                         time.perf_counter(), control=True)
        rec = {"workload": args.workload, "seed": seed,
               "frames": out["info"]["frames"],
               "compared": out["info"]["compared"],
               "sound": out["info"]["numbers"], "control": out["control"],
               "metrics": {k: v["value"]
                           for k, v in out["line"]["metrics"].items()}}
        print(json.dumps(rec), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
