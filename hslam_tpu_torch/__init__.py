"""hslam_tpu_torch — the PyTorch + CUDA port of hslam_tpu for one NVIDIA H100.

The JAX package `hslam_tpu/` stays the reference; each module here mirrors
its counterpart there (`utils/`, `ops/`, `models/`, `io/`) with the same
field names and array layouts, so the parity tests compare like with like.
This package imports torch and never jax (nor hslam_tpu, whose import pulls
jax in).

Covered: `models/system.py::SLAMSystem` as its default constructor builds
it (the hybrid configuration with loop closure on the shipped vocabulary),
through `process_frame` and the pipelined `process_frame_pipelined` with
the mapping thread and the loop-closure worker: bootstrap with direct
refinement, tracking, ORB features and indirect association, the keyframe
step, non-keyframe tracing, PnP relocalization, BoW place recognition with
PnP verification and the Sim3 pose graph (dense and matrix-free), online
photometric calibration, checkpoint/resume, the metrics stream, and the
sharded solvers of `parallel/` on torch.distributed (`dist_mesh`; one
process per rank, see parallel/__init__.py). The pyramid is a hand-written
CUDA kernel (csrc/pyramid.cu); everything else is plain torch.

Sequences from disk and the tools, each module beside its JAX counterpart:
  io/calib_io.py     hslam_tpu/io/calib_io.py (a numpy copy: lens models,
                     remap tables, camera.txt / OpenCV YAML, stereo rectify)
  io/dataset.py      hslam_tpu/io/dataset.py (a copy: TUM / EuRoC / KITTI
                     layouts, zipped or not; cv2 decode)
  io/native_loader.py  hslam_tpu/io/native_loader.py (the prefetching decode
                     and correction pool; Python threads, not the C++ library)
  io/trajectory.py   hslam_tpu/io/trajectory.py (TUM files, association, ATE)
  utils/robust.py    hslam_tpu/utils/robust.py (Huber weights on tensors)
  viz/export.py      hslam_tpu/viz/export.py (window point cloud, PLY)
  viz/debug_draw.py  hslam_tpu/viz/debug_draw.py (cv2 overlays)
  viz/view3d.py      hslam_tpu/viz/view3d.py (the live-map HTTP server)
  tools/run_sequence.py            scripts/run_sequence.py
  tools/eval_baseline.py           scripts/eval_baseline.py
  tools/profile_kf.py              scripts/profile_kf.py
  tools/train_vocab.py             scripts/train_vocab.py
  tools/make_synthetic_dataset.py  scripts/make_synthetic_dataset.py
  tools/drive_synthetic.py         scripts/drive_synthetic.py
  tools/loop_debug.py              scripts/bench_loop_debug.py
Each tool runs as `python -m hslam_tpu_torch.tools.<name>`, on the card
unless `--device cpu` is given. Not ported, being TPU machinery: the compile
cache, the precompile thread and `wait_compiles`, `LoopCloser.warmup` and
utils/devtime.py (CUDA events time the card); bench.py, the JAX package's
benchmark, is not ported either.
"""

import torch as _torch

__version__ = "0.1.0"

# Numerics policy of hslam_tpu/__init__.py: window Hessians carry priors of
# 1e14, which reduced-precision (TF32) products destroy.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
