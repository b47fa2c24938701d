"""Train a BoW vocabulary for the extractor's ORB descriptors (the
counterpart of the JAX package's tools/train_vocab.py, which trained the
shipped assets/vocab_default.npz).

The extractor uses a generated steered-BRIEF pattern (ops/orb.py), so the
reference's ORBvoc.txt does not fit it. This harvests descriptors from three
synthetic rooms (textures of seeds 0-2, viewpoints along the smooth
trajectory), deduplicates and shuffles them, and runs the hierarchical
binary k-medians (retrieval/vocab.build_vocabulary), writing the npz that
retrieval/vocab.load_vocabulary reads:

    python3 geoflowslam_tpu_torch/tools/train_vocab.py [--k 10] \
        [--levels 4] [--frames 60] [--iters 5] [--out vocab.npz] \
        [--device cuda|cpu]

The shipped asset is not overwritten unless --out names it. The device
(for rendering and extraction) is CUDA unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import os
import sys

if __name__ == "__main__":   # run as a script: the checkout's root
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from geoflowslam_tpu_torch.config import OrbConfig  # noqa: E402
from geoflowslam_tpu_torch.io.synthetic import (Camera,  # noqa: E402
                                                SyntheticSequence,
                                                SyntheticWorld)
from geoflowslam_tpu_torch.ops.extractor import extract  # noqa: E402
from geoflowslam_tpu_torch.retrieval import vocab as V  # noqa: E402


def harvest(frames: int, device) -> np.ndarray:
    """Unique descriptors [N, 8] uint32, shuffled with seed 0, of `frames`
    views spread over three rooms (the JAX tool's 640x480 camera, 600
    features, 8 levels)."""
    cam = Camera(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640,
                 height=480)
    orb = OrbConfig(n_features=600, n_levels=8, height=480, width=640)
    out = []
    for seed in range(3):
        seq = SyntheticSequence(SyntheticWorld(cam, seed=seed,
                                               device=device), fps=10.0)
        for i in range(frames // 3):
            gray, _, _ = seq.frame(i * 0.37 + seed * 11.1)
            feat = extract(gray.float(), orb)
            out.append(feat.desc[feat.valid].cpu().numpy().view(np.uint32))
    desc = np.unique(np.concatenate(out), axis=0)
    np.random.RandomState(0).shuffle(desc)
    return desc


def main(argv=None) -> V.Vocabulary:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default="vocab.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    desc = harvest(args.frames, torch.device(args.device))
    print(f"training on {len(desc)} unique descriptors "
          f"(k={args.k}, L={args.levels} -> {args.k ** args.levels} words)")
    voc = V.build_vocabulary(desc, k=args.k, levels=args.levels,
                             iters=args.iters, device="cpu")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    V.save_vocabulary(args.out, voc)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1024:.0f} KiB)")
    return voc


if __name__ == "__main__":
    main()
