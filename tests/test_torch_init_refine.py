"""hslam_tpu_torch.ops.init_refine (DirectRefinement) against the JAX
package on the inputs of tests/test_init_refine.py, plus that file's three
behaviour checks run on the port."""
import jax
import numpy as np
import pytest
import torch

from hslam_tpu.ops.init_refine import direct_refine as jrefine
from hslam_tpu_torch.config import Config
from hslam_tpu_torch.ops.init_refine import direct_refine as trefine
from test_init_refine import CFG as JCFG
from test_init_refine import _setup

torch.set_num_threads(1)

CFG = Config(max_frames=4, max_points=128, max_immature=128, pyr_levels=3)
XI = [0.10, 0.05, 0.02, 0.01, -0.02, 0.005]
XI_LOW = [0.008, 0.004, 0.001, 0.02, -0.015, 0.01]


def _port(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _run_both(args):
    j = jax.device_get(jax.jit(lambda: jrefine(*args, JCFG))())
    t = trefine(*_port(args), CFG)
    return j, t


def _case(name):
    if name == "noisy_pose":
        return _setup(XI, pose_noise=0.15)
    if name == "low_parallax":
        return _setup(XI_LOW, seed_noise=0.3)
    return _setup(XI)


@pytest.mark.parametrize("name", ["noisy_pose", "low_parallax", "default"])
def test_direct_refine_matches_jax(name):
    (d0, d1, u, v, valid, id0, tri, R0, t0, K4, *_gt) = _case(name)
    j, t = _run_both((d0, d1, u, v, valid, id0, tri, R0, t0, K4))
    # the same LM from the same start: accept/reject decisions compare f32
    # energies summed in another order, so the converged states agree to
    # what the LM resolves, not to the last bit
    np.testing.assert_array_equal(t.good.numpy(), j.good)
    assert bool(t.snapped) == bool(j.snapped)
    np.testing.assert_allclose(t.R.numpy(), j.R, atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), j.t, atol=1e-4)
    np.testing.assert_allclose(t.aff.numpy(), j.aff, atol=1e-3)
    g = j.good
    assert g.sum() > 40
    np.testing.assert_allclose(t.idepth.numpy()[g], j.idepth[g], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(t.energy), float(j.energy), rtol=1e-3)


def test_refine_improves_pose_and_idepth():
    (d0, d1, u, v, valid, id0, tri, R0, t0, K4,
     R_gt, t_gt, id_true) = _setup(XI, pose_noise=0.15)
    res = trefine(*_port((d0, d1, u, v, valid, id0, tri, R0, t0, K4)), CFG)
    good = res.good.numpy() & np.asarray(tri)
    s = np.median(res.idepth.numpy()[good]) / np.median(id_true[good])
    err_t0 = np.linalg.norm(np.asarray(t0) - t_gt)
    err_t1 = np.linalg.norm(res.t.numpy() * s - t_gt)
    assert err_t1 < err_t0 * 0.7, (err_t0, err_t1)
    e_seed = np.abs(np.asarray(id0) - id_true)[good].mean()
    e_ref = np.abs(res.idepth.numpy() / s - id_true)[good].mean()
    assert e_ref < e_seed * 0.6, (e_seed, e_ref)
    assert good.sum() > 40


def test_refine_low_parallax_does_not_collapse():
    (d0, d1, u, v, valid, id0, tri, R0, t0, K4,
     R_gt, t_gt, id_true) = _setup(XI_LOW, seed_noise=0.3)
    res = trefine(*_port((d0, d1, u, v, valid, id0, tri, R0, t0, K4)), CFG)
    assert bool(torch.isfinite(res.t).all())
    good = res.good.numpy()
    assert good.sum() > 40
    idepth = res.idepth.numpy()[good]
    assert np.mean((idepth > 0.1) & (idepth < 2.5)) > 0.9
    dR = res.R.numpy() @ R_gt.T
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 0.01


def test_refine_untriangulated_downweight():
    (d0, d1, u, v, valid, id0, _tri, R0, t0, K4,
     R_gt, t_gt, id_true) = _setup(XI)
    P = int(u.shape[0])
    tri = np.arange(P) % 2 == 0
    id_bad = np.where(tri, np.asarray(id0), 5.0).astype(np.float32)
    res = trefine(*_port((d0, d1, u, v, valid, id_bad, tri, R0, t0, K4)), CFG)
    good = res.good.numpy() & tri
    s = np.median(res.idepth.numpy()[good]) / np.median(id_true[good])
    err_t0 = np.linalg.norm(np.asarray(t0) - t_gt)
    err_t1 = np.linalg.norm(res.t.numpy() * s - t_gt)
    assert err_t1 < err_t0, (err_t0, err_t1)
