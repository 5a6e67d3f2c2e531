"""The port against tests/test_longrun.py, the JAX package's 500-frame drift
check: a slow lissajous sweep over tests/test_system.py's textured plane
with an unmodelled exposure flicker, through the sequential system with
loop closure on. It drives ~85 keyframe insertions and marginalizations
(the FEJ chain), the hybrid layer, more than 50 live loop-closure entries
and the affine brightness model in one run.

Tier 1 holds the port's JAX-free copy of the scene (io/synthetic's
sweep_texture, sweep_render, longrun_frames) to tests/test_system.py's
make_texture and render. Two slow tests: the port on the 500 frames that
the JAX package's own render draws, held to tests/test_longrun.py's bars
and to the JAX outcome recorded below; and the JAX package rerun on the
same frames, which checks that record (`./run_tests.sh
tests/test_torch_longrun.py -m slow -s`, ~5 and ~4 min on the CPU).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_system as TS
from hslam_tpu.utils import lie as jlie
from hslam_tpu_torch.config import Config
from hslam_tpu_torch.io import synthetic as syn
from hslam_tpu_torch.io.trajectory import ate_rmse
from hslam_tpu_torch.utils import lie

torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# tests/test_longrun.py:27-32
CFG_KW = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=400.0, desired_immature_density=300.0,
              tracker_iters_per_level=(6, 10, 10))
# The JAX package (XLA:CPU, sequential, loop closure on the shipped
# vocabulary) over tests/test_longrun.py's 500 frames, from
# test_longrun_jax_reference: keyframes (next_kf_id), loop-closure entries,
# loops closed, verified below significance, valid poses and the ATE over
# every frame (tests/test_longrun.py's measure). Its reruns are not bit for
# bit: an earlier run gave the same counts at ATE 0.0946. chip_smoke.py
# holds the card's run to the same bars (JAX_CPU_LONGRUN, this record).
JAX_LONGRUN = dict(frames=500, valid=500, keyframes=84, entries=83, loops_closed=2,
                   verified_insignificant=0, ate=0.09761475765813628)


def _jax_frames(n=syn.LONGRUN_FRAMES):
    """tests/test_longrun.py:37-48's frames and ground truth, drawn by the
    JAX package's render."""
    I0 = TS.make_texture()
    frames, gt = [], []
    for i in range(n):
        R, t = jlie.se3_exp(jnp.array(syn.longrun_xi(i / 10.0)))
        frames.append(np.clip(TS.render(I0, R, t) * syn.longrun_gain(i), 0, 255))
        Tcw = np.eye(4)
        Tcw[:3, :3], Tcw[:3, 3] = np.asarray(R), np.asarray(t)
        gt.append(np.linalg.inv(Tcw))
    return frames, gt


# ------------------------------------------------------------ the scene copy
def test_sweep_texture_constants_are_the_jax_draws():
    key = jax.random.PRNGKey(3)
    ky, kx = jax.random.uniform(key, (2, 8), minval=0.5, maxval=6.5)
    ph = jax.random.uniform(jax.random.fold_in(key, 1), (8,))
    for mine, draw in ((syn.SWEEP_KY, ky), (syn.SWEEP_KX, kx), (syn.SWEEP_PH, ph)):
        assert np.asarray(mine, np.float32).tobytes() == np.asarray(draw).tobytes()


def test_sweep_texture_matches_jax():
    mine = syn.sweep_texture()
    assert mine.dtype == torch.float32 and tuple(mine.shape) == (TS.H, TS.W)
    np.testing.assert_allclose(mine.numpy(), np.asarray(TS.make_texture()), rtol=0, atol=1e-4)


@pytest.mark.parametrize("i", [0, 137, 499])
def test_longrun_frames_match_jax_render(i):
    """The port's frame i (sweep pose, render, gain, clip) against the
    JAX package's, within 1e-3 grey levels, with the same ground truth."""
    frames, stamps, gt = syn.longrun_frames(i + 1)
    want, want_gt = _jax_frames(i + 1)
    assert frames[i].dtype == np.float32 and stamps[i] == i / 10.0
    np.testing.assert_allclose(frames[i], want[i], rtol=0, atol=1e-3)
    R, t = lie.se3_exp(torch.tensor(syn.longrun_xi(i / 10.0), dtype=torch.float32))
    np.testing.assert_allclose(
        syn.sweep_render(syn.sweep_texture(), R, t).numpy(),
        TS.render(TS.make_texture(), *jlie.se3_exp(jnp.array(syn.longrun_xi(i / 10.0)))),
        rtol=0, atol=1e-3)
    np.testing.assert_allclose(gt[i], want_gt[i], rtol=0, atol=1e-6)


# ------------------------------------------------------------ the whole run
def _outcome(slam, gt, lost):
    est = np.array([s.cam_to_world[:3, 3] for s in slam.shells])
    lcl = slam.loop_closer
    return dict(frames=len(slam.shells), valid=sum(s.pose_valid for s in slam.shells),
                keyframes=slam.next_kf_id, entries=len(lcl.entries),
                loops_closed=slam.n_loops_closed,
                verified_insignificant=lcl.n_verified_insignificant,
                ate=float(ate_rmse(np.array([g[:3, 3] for g in gt]), est)), lost=lost)


def _hold_drift_bars(got):
    """tests/test_longrun.py's bars."""
    assert got["lost"] == [], f"lost at frames {got['lost']}"
    assert got["keyframes"] > 50 and got["entries"] > 50
    assert np.isfinite(got["ate"]) and got["ate"] < 0.20, got


@pytest.mark.slow
def test_longrun_port_holds_the_drift_bars():
    """The port's sequential system on the CPU over the JAX-drawn 500
    frames, twice: tests/test_longrun.py's bars, and the two runs the same
    bits, so that the keyframe count is held within 15% of the JAX
    package's (not to +-1: on the card, whose arithmetic differs in the
    last bits, the count moves, C20)."""
    from hslam_tpu_torch.models.system import SLAMSystem
    frames, gt = _jax_frames()
    runs = []
    for _ in range(2):
        slam = SLAMSystem(TS.FX, TS.FY, TS.CX, TS.CY, TS.W, TS.H, Config(**CFG_KW),
                          device="cpu")
        lost = []
        for i, f in enumerate(frames):
            slam.process_frame(f, i / 10.0)
            if slam.is_lost:
                lost.append(i)
        slam.close()
        runs.append((slam, _outcome(slam, gt, lost)))
    (slam, got), (again, got2) = runs
    print(f"port 500-frame drift run (CPU): {got}; again: {got2}; JAX {JAX_LONGRUN}")
    assert slam.initialized
    _hold_drift_bars(got)
    assert got == got2 and all(np.array_equal(a.cam_to_world, b.cam_to_world)
                               for a, b in zip(slam.shells, again.shells))
    assert got["valid"] == JAX_LONGRUN["valid"]
    assert abs(got["keyframes"] - JAX_LONGRUN["keyframes"]) <= 0.15 * JAX_LONGRUN["keyframes"]


@pytest.mark.slow
def test_longrun_jax_reference():
    """tests/test_longrun.py's run of the JAX package, checked against the
    record the port is held to."""
    from hslam_tpu.config import Config as JConfig
    from hslam_tpu.models.system import SLAMSystem as JSLAM
    frames, gt = _jax_frames()
    slam = JSLAM(TS.FX, TS.FY, TS.CX, TS.CY, TS.W, TS.H, JConfig(**CFG_KW))
    lost = []
    for i, f in enumerate(frames):
        slam.process_frame(f, i / 10.0)
        if slam.is_lost:
            lost.append(i)
    slam.close()
    got = _outcome(slam, gt, lost)
    print(f"JAX 500-frame drift run: {got}")
    _hold_drift_bars(got)
    import chip_smoke
    ref = JAX_LONGRUN
    assert chip_smoke.JAX_CPU_LONGRUN == ref
    assert (got["frames"], got["valid"]) == (ref["frames"], ref["valid"])
    # XLA:CPU reruns differ in the last bits, and 500 frames amplify that:
    # the counts within 15%, the ATE within 25%, as the loop sequence's
    # record is held
    for k in ("keyframes", "entries"):
        assert abs(got[k] - ref[k]) <= 0.15 * ref[k], (k, got[k], ref[k])
    assert abs(got["ate"] - ref["ate"]) <= 0.25 * ref["ate"], (got["ate"], ref["ate"])
