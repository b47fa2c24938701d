"""geoflowslam_tpu_torch — the PyTorch/CUDA port of geoflowslam_tpu.

The package keeps the JAX package's layout (math/, ops/, state/, solvers/,
pipeline/, io/, eval/) so that every module's counterpart is easy to find.
It imports torch and numpy only. The two TPU kernels on the RGB-D main path
(FAST-9 scoring and the gated projection Hamming search) are hand-written
CUDA C++ for sm_90a under kernels/; every other op is plain PyTorch.

Device rule: functions follow the device of their input tensors. CUDA
tensors go to the hand-written kernels, CPU tensors to the plain PyTorch
versions beside them; a failed build or launch raises.
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM geometry (Rodrigues, GN and Schur solves) needs true float32 matmuls,
# the counterpart of the JAX package's "highest" matmul precision: TF32
# keeps about three decimal digits and corrupts rotation compositions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
