"""k2_rows: every gated projection search (ops/matching.py's
`gated_hamming`, K2) of the probed frames, recomputed from the arguments
the program passed (its map's projections and descriptors: the reference
follows the program one stage at a time here). The number is the share of
query rows whose (best, second, index) differ from the reference's."""
import torch

from slam_bench.check import clone
from slam_bench.reference import search as RS

NUMBERS = ("k2_rows",)
TARGETS = (("geoflowslam_tpu_torch.ops.matching", "gated_hamming"),)


def keep(kept, frame, target, args, kwargs, out):
    kept.setdefault(frame, []).append((clone(args), clone(out)))


def numbers(kept, outputs, lowp):
    bad = total = 0
    for calls in kept.values():
        for args, out in calls:
            ref = RS.gated_search(*args)
            if lowp:
                out = RS.gated_search(*args, lowp=True)
            diff = torch.zeros_like(ref[0], dtype=torch.bool)
            for g, w in zip(out, ref):
                diff |= g.to(w.device).long() != w.long()
            bad, total = bad + int(diff.sum()), total + diff.numel()
    return ({"k2_rows": bad / total if total else None}, {"k2_rows": total})
