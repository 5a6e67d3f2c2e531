"""hslam_tpu_torch.utils (lie, interp, compaction) against the JAX package
on the same numpy inputs, and compaction against its documented semantics."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.utils import compaction as jcomp
from hslam_tpu.utils import interp as jint
from hslam_tpu.utils import lie as jlie
from hslam_tpu_torch.utils import compaction as tcomp
from hslam_tpu_torch.utils import interp as tint
from hslam_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)
RNG = np.random.default_rng(0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rotations(n=64):
    # angles from ~0 (Taylor branch) to near pi
    w = RNG.normal(size=(n, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    ang = np.concatenate([np.zeros(2), 10.0 ** RNG.uniform(-6, 0.49, n - 2)])
    return (w * ang[:, None]).astype(np.float32)


# f32 evaluation of the same closed forms in two libraries: ~1e-6 absolute
LIE_ATOL = 2e-5
# (1 - cos t)/t^2 and (t - sin t)/t^3 cancel in f32 for t just above the
# 1e-4 Taylor switch: a one-ulp difference of cos/sin between the libraries
# moves the Jacobian (and se3_exp's translation) by up to ~1e-4 there
JAC_ATOL = 2e-4


@pytest.mark.parametrize("fn,atol", [("hat", 0.0), ("so3_exp", LIE_ATOL),
                                     ("so3_left_jacobian", JAC_ATOL),
                                     ("so3_left_jacobian_inv", JAC_ATOL)])
def test_so3_functions_match(fn, atol):
    w = _rotations()
    a = np.asarray(getattr(jlie, fn)(jnp.asarray(w)))
    b = getattr(tlie, fn)(_t(w)).numpy()
    np.testing.assert_allclose(b, a, atol=atol)


def test_se3_exp_log_adjoint_match():
    xi = np.concatenate([RNG.normal(size=(64, 3)) * 0.5, _rotations()], 1).astype(np.float32)
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    Rt, tt = tlie.se3_exp(_t(xi))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=LIE_ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=JAC_ATOL)
    # log (quaternion route, stable near 0 and pi) and adjoint on the
    # same (R, t) inputs in both packages
    Rn, tn = np.asarray(Rj), np.asarray(tj)
    np.testing.assert_allclose(tlie.se3_log(_t(Rn), _t(tn)).numpy(),
                               np.asarray(jlie.se3_log(Rj, tj)), atol=JAC_ATOL)
    np.testing.assert_allclose(tlie.se3_adjoint(_t(Rn), _t(tn)).numpy(),
                               np.asarray(jlie.se3_adjoint(Rj, tj)), atol=LIE_ATOL)
    Ri, ti = tlie.se3_inverse(Rt, tt)
    Rm, tm = tlie.se3_mul(Rt, tt, Ri, ti)
    np.testing.assert_allclose(Rm.numpy(), np.broadcast_to(np.eye(3), Rm.shape), atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), 0.0, atol=1e-5)


def test_quaternions_match():
    q = RNG.normal(size=(64, 4)).astype(np.float32)
    R = np.asarray(jlie.quat_to_rot(jnp.asarray(q)))
    np.testing.assert_allclose(tlie.quat_to_rot(_t(q)).numpy(), R, atol=LIE_ATOL)
    np.testing.assert_allclose(tlie.rot_to_quat(_t(R)).numpy(),
                               np.asarray(jlie.rot_to_quat(jnp.asarray(R))), atol=1e-5)


IMG = (RNG.uniform(0, 255, (24, 31))).astype(np.float32)
# sample sites inside, on the edges and far outside (clamped, interp.py:25-29)
XS = np.concatenate([RNG.uniform(-3, 34, 200), [0.0, 30.0, 29.999, -5, 40]]).astype(np.float32)
YS = np.concatenate([RNG.uniform(-3, 27, 200), [0.0, 23.0, 22.999, 30, -2]]).astype(np.float32)


def test_bilinear_match():
    np.testing.assert_allclose(tint.bilinear(_t(IMG), _t(XS), _t(YS)).numpy(),
                               np.asarray(jint.bilinear(IMG, XS, YS)), rtol=1e-6, atol=1e-4)
    img3 = np.stack([IMG, IMG * 0.5, -IMG], -1)
    np.testing.assert_allclose(tint.bilinear(_t(img3), _t(XS), _t(YS)).numpy(),
                               np.asarray(jint.bilinear(img3, XS, YS)), rtol=1e-6, atol=1e-4)


def test_bilinear_with_grad_match():
    a = jint.bilinear_with_grad(IMG, XS, YS)
    b = tint.bilinear_with_grad(_t(IMG), _t(XS), _t(YS))
    for x, y in zip(b, a):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-4)


def test_packed_cells_match():
    pj = jint.pack_cells(IMG)
    pt = tint.pack_cells(_t(IMG))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(tint.bilinear_packed(pt, _t(XS), _t(YS)).numpy(),
                               np.asarray(jint.bilinear_packed(pj, XS, YS)),
                               rtol=1e-6, atol=1e-4)


def _documented(free, cand, values, init):
    """j-th valid candidate -> j-th free slot, in index order."""
    out = np.array(init, copy=True)
    free_idx = np.flatnonzero(free)
    j = 0
    for c, val in zip(cand, values):
        if c:
            if j < len(free_idx):
                out[free_idx[j]] = val
            j += 1
    return out


@pytest.mark.parametrize("free,cand", [
    ([1] * 8, [1, 0, 1, 0, 0, 0]),
    ([1] * 8, [1, 1, 1, 0, 0, 0]),
    ([1] * 8, [1, 1, 1, 1, 1, 1]),
    ([0, 1, 0, 1, 1, 0, 0, 1], [0, 1, 1, 0, 1, 1]),     # 4 free, 4 valid
    ([0, 1, 0, 0, 0, 0, 0, 1], [1, 1, 1, 0, 0, 1]),     # overflow: 2 fit
    ([0] * 8, [1, 1, 0, 0, 0, 0]),                      # no free slot
])
def test_compaction_documented_semantics(free, cand):
    free = np.asarray(free, bool)
    cand = np.asarray(cand, bool)
    values = np.arange(1, len(cand) + 1, dtype=np.float32)
    init = -np.ones(len(free), np.float32)
    slots, write = tcomp.assign_free_slots(_t(free), _t(cand))
    got = tcomp.scatter_update(_t(init), slots, write, _t(values)).numpy()
    np.testing.assert_array_equal(got, _documented(free, cand, values, init))
    # 2-D rows go the same way
    rows = np.repeat(values[:, None], 3, 1)
    got2 = tcomp.scatter_update(_t(np.repeat(init[:, None], 3, 1)), slots, write,
                                _t(rows)).numpy()
    np.testing.assert_array_equal(got2[:, 0], got)


def test_compaction_c1_divergence_from_jax():
    """Fault C1 of the JAX package: its scatter_update sends unwritten
    candidates (with their slot's old value) to the slot of the valid
    candidate before them, so on XLA:CPU the inserts of [1,0,1,0,0,0] are
    lost. The port writes only the real inserts (documented semantics)."""
    free = np.ones(8, bool)
    cand = np.array([1, 0, 1, 0, 0, 0], bool)
    values = np.arange(1, 7, dtype=np.float32)
    init = np.zeros(8, np.float32)
    js, jw = jcomp.assign_free_slots(jnp.asarray(free), jnp.asarray(cand))
    jax_out = np.asarray(jcomp.scatter_update(jnp.asarray(init), js, jw, jnp.asarray(values)))
    ts, tw = tcomp.assign_free_slots(_t(free), _t(cand))
    port_out = tcomp.scatter_update(_t(init), ts, tw, _t(values)).numpy()
    documented = _documented(free, cand, values, init)
    np.testing.assert_array_equal(port_out, documented)          # [1, 3, 0, ...]
    # recorded divergence: the JAX package loses at least one insert here
    assert not np.array_equal(jax_out, documented)
    np.testing.assert_array_equal(jax_out, np.zeros(8, np.float32))
    # both packages agree on the slot assignment itself
    np.testing.assert_array_equal(ts.numpy()[tw.numpy()], np.asarray(js)[np.asarray(jw)])
