"""hslam_tpu_torch — the PyTorch + CUDA port of hslam_tpu for one NVIDIA H100.

The JAX package `hslam_tpu/` stays the reference; each module here mirrors
its counterpart there (`utils/`, `ops/`, `models/`, `io/`) with the same
field names and array layouts, so the parity tests compare like with like.
This package imports torch and never jax (nor hslam_tpu, whose import pulls
jax in).

Covered: the default hybrid configuration of `models/system.py::SLAMSystem`
without loop closure, through `process_frame` and the pipelined
`process_frame_pipelined` with the mapping thread (bootstrap with direct
refinement, tracking, ORB features and indirect association, the keyframe
step, non-keyframe tracing, PnP relocalization). The per-level pyramid
pass is a hand-written CUDA kernel (csrc/pyramid.cu); everything else is
plain torch.
"""

import torch as _torch

__version__ = "0.1.0"

# Numerics policy of hslam_tpu/__init__.py: window Hessians carry priors of
# 1e14, which reduced-precision (TF32) products destroy.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
