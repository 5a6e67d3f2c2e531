"""The whole direct-only slice: the same numpy-rendered frames through
hslam_tpu.models.system.SLAMSystem.process_frame and through the port's.

Outcome-based tolerance: the JAX package loses inserted points to fault C1
(see test_torch_utils.py) and the two packages draw different random
numbers (C3: selector subsampling, RANSAC samples), so trajectories are
compared by what they achieve, not sample by sample."""
import numpy as np
import pytest
import torch

from hslam_tpu.config import Config as JConfig
from hslam_tpu.models.system import SLAMSystem as JSLAM
from hslam_tpu_torch.config import Config
from hslam_tpu_torch.io.synthetic import Scene, make_sequence, sweep_xi
from hslam_tpu_torch.io.trajectory import ate_rmse
from hslam_tpu_torch.models.system import SLAMSystem as TSLAM

torch.set_num_threads(1)

H, W, FX = 96, 128, 80.0
# the small config of tests/test_system.py:50-55, direct-only
CFG_KW = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=400.0, desired_immature_density=300.0,
              tracker_iters_per_level=(6, 10, 10), enable_indirect=False,
              init_direct_refine=False)
N_FRAMES = 20


def _run(slam, frames):
    for i, f in enumerate(frames):
        slam.process_frame(f, i / 10.0)
        assert not slam.is_lost, f"lost at frame {i}"
    valid = [s.id for s in slam.shells if s.pose_valid]
    est = np.array([slam.shells[i].cam_to_world[:3, 3] for i in valid])
    return valid, est


@pytest.mark.parametrize("quantize", [True, False], ids=["uint8", "float"])
def test_slice_matches_jax_outcome(quantize):
    frames, centres = make_sequence(Scene(H, W, FX, n_blobs=16), N_FRAMES,
                                    lambda i: sweep_xi(i / 10.0), quantize=quantize)
    js = JSLAM(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, JConfig(**CFG_KW),
               enable_loop_closure=False)
    ts = TSLAM(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, Config(**CFG_KW),
               enable_loop_closure=False, device="cpu")
    jv, jest = _run(js, frames)
    tv, test = _run(ts, frames)
    assert js.initialized and ts.initialized
    assert ts.next_kf_id >= 3
    assert abs(ts.next_kf_id - js.next_kf_id) <= 1, (ts.next_kf_id, js.next_kf_id)
    assert len(tv) == N_FRAMES and len(jv) == N_FRAMES
    assert ts.n_relocs == 0
    ate_j = ate_rmse(centres[jv], jest)
    ate_t = ate_rmse(centres[tv], test)
    # scene depth 2.0: both are millimetre-level on this sequence
    assert np.isfinite(ate_t) and ate_t <= max(1.5 * ate_j, 0.02), (ate_t, ate_j)
