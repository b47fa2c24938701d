"""Run the JAX package's hard-mode driver (examples/run_hardmode.py) on the
CPU as the reference for the port's hard-mode windows, with its caches kept
under this directory (.jax_cache/, .frames/; both ignored by git).

    JAX_PLATFORMS=cpu python results_hard_torch/reference_cpu/run_reference.py \
        --mode rgbd_inertial --frames 300 \
        --out results_hard_torch/reference_cpu/rgbd_inertial_300 [--sync]

Every argument but --sync goes to the driver unchanged. --sync sets the
driver's SystemConfig to pkt_max_pending=0: each frame's host decisions
(KF insertion, VI acceptance, recovery) are made before the next frame is
dispatched, as the port makes them; without it the driver's default (up to
16 frames in flight) decides up to a read batch late.
"""
import functools
import os
import runpy
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main() -> None:
    sys.path.insert(0, ROOT)
    os.environ.setdefault("GFS_FRAME_CACHE", os.path.join(HERE, ".frames"))
    import geoflowslam_tpu.pipeline.system as S
    import geoflowslam_tpu.utils.compile_log as CL
    enable = CL.enable_persistent_cache
    CL.enable_persistent_cache = lambda *a, **k: enable(
        os.path.join(HERE, ".jax_cache"))
    args = sys.argv[1:]
    if "--sync" in args:
        args.remove("--sync")
        S.SystemConfig = functools.partial(S.SystemConfig, pkt_max_pending=0)
    sys.argv = ["examples/run_hardmode.py"] + args
    runpy.run_path(os.path.join(ROOT, "examples", "run_hardmode.py"),
                   run_name="__main__")


if __name__ == "__main__":
    main()
