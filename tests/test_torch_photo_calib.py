"""Online photometric calibration and per-frame correction in the port
(hslam_tpu_torch/ops/undistort.py, models/photo_calib.py and the calibrated
paths of models/system.py) against the JAX package, on the CPU.

Tolerances: elementwise functions within 1e-5 (f32 rounding of the same
formulas). The calibration fit is a Gauss-Newton over [u_raw (16),
u_span_raw, vig (3), log_exp (F)]; the port writes its Jacobian out, held
here to `torch.func.jacfwd` at 1e-5. Its f32 normal equations are ill
conditioned in the response's knots (ROADMAP C13): from `init_params` one
step differs between the packages by up to 1.0e-2 in u_raw and 1.4e-4 in
the vignette with the fixture below, while the JAX package's own f32 step
differs from a float64 solve of the same system by up to 0.59 in u_raw
(known exposure, cold start). So one step is held at 5e-4 on the vignette,
1e-4 on the exposures, 0.5% on the RMS and 3e-2 on the knots; the converged
fit is held on what the system uses, the LUT and the RMS."""
import math
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.config import Config as JConfig
from hslam_tpu.models import photo_calib as JPC
from hslam_tpu.models.system import SLAMSystem as JSLAM
from hslam_tpu.ops import undistort as JU
from hslam_tpu_torch.config import Config
from hslam_tpu_torch.convert import from_numpy, to_numpy
from hslam_tpu_torch.io.synthetic import Scene, make_photocal_frames
from hslam_tpu_torch.io.trajectory import ate_rmse
from hslam_tpu_torch.models import photo_calib as TPC
from hslam_tpu_torch.models.system import Shell as TShell
from hslam_tpu_torch.models.system import SLAMSystem
from hslam_tpu_torch.ops import tracker as trk
from hslam_tpu_torch.ops import undistort as TU

torch.set_num_threads(1)

H, W, FX = 96, 128, 80.0
CX, CY = W / 2 - 0.5, H / 2 - 0.5
CFG_KW = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=400.0, desired_immature_density=300.0,
              tracker_iters_per_level=(6, 10, 10))


def t(x, dtype=None):
    a = np.array(x)
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


def err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ------------------------------------------------------------- undistort
def _luts():
    x = np.arange(256, dtype=np.float32)
    gamma = (255.0 * (x / 255.0) ** 0.7).astype(np.float32)
    inv_resp = (255.0 * (x / 255.0) ** 1.4).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    r2 = ((xs - CX) ** 2 + (ys - CY) ** 2) / (CX ** 2 + CY ** 2)
    inv_vig = (1.0 / (1.0 - 0.9 * r2)).astype(np.float32)    # up to 10: values past 255
    return gamma, inv_resp, inv_vig


@pytest.mark.parametrize("case", ["remap_image", "photometric_correct",
                                  "photometric_correct_lut_only", "invert_response",
                                  "response_grad_weight"])
def test_undistort_matches_jax(case):
    rng = np.random.default_rng(3)
    gamma, inv_resp, inv_vig = _luts()
    # raw intensities below 0, between integers, at 255 and past it
    raw = rng.uniform(-3.0, 260.0, (H, W)).astype(np.float32)
    raw[0, :4] = [0.0, 254.5, 255.0, 300.0]
    if case == "remap_image":
        remap = np.stack([rng.uniform(-1, W, (H, W)), rng.uniform(-1, H, (H, W))],
                         -1).astype(np.float32)
        remap[:3, :3, 0] = -1.0
        a, b = JU.remap_image(jnp.asarray(raw), jnp.asarray(remap)), TU.remap_image(t(raw), t(remap))
        assert float(b[0, 0]) == 0.0
    elif case == "photometric_correct":
        a = JU.photometric_correct(jnp.asarray(raw), jnp.asarray(inv_resp), jnp.asarray(inv_vig))
        b = TU.photometric_correct(t(raw), t(inv_resp), t(inv_vig))
        assert float(b.max()) > 255.0
    elif case == "photometric_correct_lut_only":
        a = JU.photometric_correct(jnp.asarray(raw), jnp.asarray(inv_resp), None)
        b = TU.photometric_correct(t(raw), t(inv_resp), None)
    elif case == "invert_response":
        # a monotone curve with flat stretches (searchsorted ties, g1 == g0)
        g = np.round(gamma / 4.0).astype(np.float32) * 4.0
        a, b = JU.invert_response(jnp.asarray(g)), TU.invert_response(t(g))
    else:
        a, b = JU.response_grad_weight(jnp.asarray(gamma)), TU.response_grad_weight(t(gamma))
    assert b.shape == a.shape and b.dtype == torch.float32
    assert err(a, b) <= 1e-5 * max(1.0, float(np.abs(np.asarray(a)).max())), err(a, b)


# ------------------------------------------------------ the calibration model
def _problem(seed=0, P=400, F=8, spread=0.1, lo=2.0, hi=250.0):
    """Tracked-point observations of a ground-truth gamma-0.7 response,
    vignette 1 - 0.3 r^2 and log exposures in [-spread, spread]."""
    rng = np.random.default_rng(seed)
    gt_le = np.concatenate([[0.0], rng.uniform(-spread, spread, F - 1)]).astype(np.float32)
    L = rng.uniform(lo, hi, P).astype(np.float32)
    r2 = rng.uniform(0.0, 1.0, (P, F)).astype(np.float32)
    irr = np.exp(gt_le)[None, :] * (1.0 - 0.3 * r2) * L[:, None]
    obs = np.clip(255.0 * (np.clip(irr, 0.0, 255.0) / 255.0) ** 0.7, 0.0, 255.0).astype(np.float32)
    mask = (irr > 5.0) & (irr < 250.0)
    return dict(obs=obs, r2=r2, mask=mask, gt_le=gt_le, exp=np.exp(gt_le).astype(np.float32))


def _params(rng, F):
    return [rng.normal(0, 0.3, 16).astype(np.float32), np.float32(rng.normal(5.0, 0.5)),
            np.array([-0.2, 0.02, -0.01], np.float32), rng.normal(0, 0.2, F).astype(np.float32)]


@pytest.mark.parametrize("fn", ["U", "log_vignette", "residuals_PF", "residuals_F"])
def test_model_functions_match_jax(fn):
    pb = _problem(1)
    F = pb["obs"].shape[1]
    raw = _params(np.random.default_rng(2), F)
    jp = JPC.PhotoParams(*(jnp.asarray(x) for x in raw))
    tp = TPC.PhotoParams(*(t(x) for x in raw))
    if fn == "U":
        obs = np.concatenate([pb["obs"].ravel(), [-1.0, 0.0, 255.0, 300.0]]).astype(np.float32)
        a, b = JPC._U(jp, jnp.asarray(obs)), TPC._U(tp, t(obs))
    elif fn == "log_vignette":
        a, b = JPC._log_vignette(jp, jnp.asarray(pb["r2"])), TPC._log_vignette(tp, t(pb["r2"]))
    else:
        fi = np.arange(F, dtype=np.int32)
        if fn == "residuals_PF":
            fi = np.broadcast_to(fi[None], pb["obs"].shape).copy()
        a = JPC.residuals(jp, jnp.asarray(pb["obs"]), jnp.asarray(fi),
                          jnp.asarray(pb["r2"]), jnp.asarray(pb["mask"]))
        b = TPC.residuals(tp, t(pb["obs"]), t(fi).long(), t(pb["r2"]), t(pb["mask"]))
    assert err(a, b) <= 1e-5, err(a, b)


@pytest.mark.parametrize("frame_idx", ["F", "PF"])
@pytest.mark.parametrize("known", [False, True], ids=["unknown_exposure", "known_exposure"])
@pytest.mark.parametrize("warm", [False, True], ids=["no_prior", "prior"])
def test_jacobian_matches_forward_mode_ad(warm, known, frame_idx):
    """The written-out Jacobian of the fit's residual vector against
    torch.func.jacfwd of the same residuals (the JAX package's route), with
    observations outside [0, 255], radii past the vignette clamp, and the
    gauge pin's column exactly zero."""
    pb = _problem(4, P=300)
    F = pb["obs"].shape[1]
    rng = np.random.default_rng(6)
    obs = pb["obs"].copy()
    obs[:5, 0] = [-3.0, 0.0, 255.0, 260.0, 128.0]
    r2 = (pb["r2"] * 1.5).astype(np.float32)
    raw = _params(rng, F)
    raw[2] = np.array([-0.8, 0.3, -0.1], np.float32)       # V leaves [0.1, 4] for some radii
    p = TPC._flatten(TPC.PhotoParams(*(t(x) for x in raw)))
    fi = np.arange(F) if frame_idx == "F" else np.broadcast_to(np.arange(F)[None], obs.shape)
    prev = TPC.PhotoParams(*(t(x) for x in _params(rng, F))) if warm else None
    res, jac, _ = TPC._gn_functions(16, F, t(obs), t(fi).long(), t(r2), t(pb["mask"]), 0.3,
                                    (0.02, 0.2, 2.0), t(pb["exp"]) if known else None, prev, 0.5)
    Ja, Jf = jac(p), torch.func.jacfwd(res)(p)
    assert Ja.shape == Jf.shape == (res(p).shape[0], 16 + 4 + F)
    assert float((Ja - Jf).abs().max()) <= 1e-5 * float(Jf.abs().max())
    assert bool((Ja[:, 16 + 4] == 0).all())


@pytest.mark.parametrize("known", [False, True], ids=["unknown_exposure", "known_exposure"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_one_gauss_newton_iteration_matches_jax(known, warm):
    """One iteration of calibrate from init_params (cold) or from a previous
    fit's parameters with the prior toward them (warm), with the exposures
    unknown or pinned to the telemetry."""
    pb = _problem(0)
    F = pb["obs"].shape[1]
    raw = _params(np.random.default_rng(5), F)
    prev_j = JPC.PhotoParams(*(jnp.asarray(x) for x in raw))
    p0_j = prev_j._replace(log_exp=jnp.zeros(F)) if warm else JPC.init_params(F)
    p0_t = TPC.PhotoParams(*(t(x, np.float32) for x in p0_j))
    prev_t = TPC.PhotoParams(*(t(x) for x in raw))
    fi = np.arange(F, dtype=np.int32)
    jp, jr = JPC.calibrate(p0_j, jnp.asarray(pb["obs"]), jnp.asarray(fi), jnp.asarray(pb["r2"]),
                           jnp.asarray(pb["mask"]), n_iters=1,
                           exp_known=jnp.asarray(pb["exp"]) if known else None,
                           prev=prev_j if warm else None)
    tp, tr = TPC.calibrate(p0_t, t(pb["obs"]), t(fi).long(), t(pb["r2"]), t(pb["mask"]), n_iters=1,
                           exp_known=t(pb["exp"]) if known else None,
                           prev=prev_t if warm else None)
    # the step moved the parameters (an accepted step), identically in both
    assert err(jp.log_exp, p0_j.log_exp) > 1e-3 and err(tp.log_exp, p0_t.log_exp) > 1e-3
    assert err(jp.vig, tp.vig) <= 5e-4 and err(jp.log_exp, tp.log_exp) <= 1e-4
    assert abs(float(jr) - float(tr)) <= 5e-3 * float(jr)
    assert err(jp.u_raw, tp.u_raw) <= 3e-2 and err(jp.u_span_raw, tp.u_span_raw) <= 3e-2
    assert float(tp.log_exp[0]) == float(p0_t.log_exp[0])     # the gauge pin's column is zero


def test_recovers_exposures_and_response():
    """tests/test_photo_calib.py::test_recovers_exposures_and_response with
    numpy draws, through the port (its own assertions), and held to the JAX
    package's fit of the same observations."""
    rng = np.random.default_rng(0)
    P, F = 200, 8
    gt_le = np.concatenate([[0.0], rng.uniform(-0.4, 0.4, F - 1)]).astype(np.float32)
    a2_gt = -0.3
    L = rng.uniform(30.0, 220.0, P).astype(np.float32)
    r2 = rng.uniform(0.0, 1.0, (P, F)).astype(np.float32)
    irr = np.exp(gt_le)[None, :] * (1.0 + a2_gt * r2) * L[:, None]
    obs = np.clip(255.0 * (np.clip(irr, 0.0, 255.0) / 255.0) ** 0.7, 0.0, 255.0).astype(np.float32)
    mask = (irr > 5.0) & (irr < 250.0)
    frame_idx = np.broadcast_to(np.arange(F)[None, :], (P, F)).copy()

    fitted, rms = TPC.calibrate(TPC.init_params(F, device="cpu"), t(obs), t(frame_idx),
                                t(r2), t(mask), n_iters=30)
    assert float(rms) < 0.08, f"residual rms {rms}"
    est = fitted.log_exp.numpy() - float(fitted.log_exp[0])
    corr = np.corrcoef(est, gt_le)[0, 1]
    alpha = np.polyfit(gt_le, est, 1)[0]
    assert corr > 0.99 and 0.1 < alpha < 10.0, (corr, alpha)
    a2_est = float(fitted.vig[0])
    assert abs(a2_est - alpha * a2_gt) < 0.3 * abs(alpha * a2_gt) + 0.05, (a2_est, alpha * a2_gt)
    lut = TPC.gamma_lut(fitted).numpy()
    assert lut.shape == (256,) and (np.diff(lut) >= -1e-3).all()
    vm = TPC.vignette_map(fitted, 24, 32).numpy()
    assert vm.shape == (24, 32) and vm[12, 16] > vm[0, 0]

    jfit, jrms = JPC.calibrate(JPC.init_params(F), jnp.asarray(obs), jnp.asarray(frame_idx),
                               jnp.asarray(r2), jnp.asarray(mask), n_iters=30)
    # the converged fit: the response LUT and the RMS; u_span_raw ends on
    # softplus' flat tail in both (the span at its floor 0.5)
    assert err(JPC.gamma_lut(jfit), lut) <= 1e-3, err(JPC.gamma_lut(jfit), lut)
    assert abs(float(jrms) - float(rms)) <= 1e-6
    assert err(jfit.vig, fitted.vig) <= 1e-5 and err(jfit.log_exp, fitted.log_exp) <= 1e-5


@pytest.mark.parametrize("fn", ["gamma_lut", "vignette_map"])
def test_lut_and_vignette_map_match_jax(fn):
    raw = _params(np.random.default_rng(7), 4)
    jp = JPC.PhotoParams(*(jnp.asarray(x) for x in raw))
    tp = TPC.PhotoParams(*(t(x) for x in raw))
    if fn == "gamma_lut":
        a, b = JPC.gamma_lut(jp), TPC.gamma_lut(tp)
        assert (np.diff(b.numpy()) >= -1e-3).all()
        tol = 1e-3          # 255 x the f32 rounding of the normalized irradiance
    else:
        a, b = JPC.vignette_map(jp, 37, 53), TPC.vignette_map(tp, 37, 53)
        tol = 1e-6
    assert b.shape == a.shape
    assert err(a, b) <= tol, err(a, b)


def test_init_params_and_converter():
    p = TPC.init_params(5, device="cpu")
    j = JPC.init_params(5)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = to_numpy(from_numpy(jax.device_get(j), "cpu"))
    assert type(from_numpy(jax.device_get(j), "cpu")) is TPC.PhotoParams
    for a, b in zip(j, back):
        np.testing.assert_array_equal(np.asarray(a), b)


# ------------------------------------------- the calibrated system paths
@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's sequential system with online calibration on, over
    14 frames of the photocal sequence at 96x128: initialized, the ring of
    raw frames full, no fit yet."""
    frames, exps, _ = make_photocal_frames(Scene(H, W, FX, n_blobs=16), 14)
    js = JSLAM(FX, FX, CX, CY, W, H, JConfig(**CFG_KW), online_photo_calib=True,
               photo_calib_every=8, enable_loop_closure=False)
    for i, f in enumerate(frames):
        js.process_frame(f, 0.05 * i, exposure=exps[i])
    assert js.initialized and len(js._pc_ring) == 8 and js._pc_params is None
    saved = dict(template=js.template, ring=list(js._pc_ring))
    return js, saved


def _reset_jax(js, saved):
    js.template = saved["template"]
    js._pc_ring = deque(saved["ring"], maxlen=8)
    js._pc_params = js._pc_rms = None
    js._inv_response = js._inv_vignette = js._grad_weight = None
    js._pc_window_resync = False


def _port_from(js):
    """A port system holding the JAX system's tracking state and ring."""
    ts = SLAMSystem(FX, FX, CX, CY, W, H, Config(**CFG_KW), online_photo_calib=True,
                    photo_calib_every=8, enable_loop_closure=False, device="cpu")
    ts.template = from_numpy(jax.device_get(js.template), "cpu")
    ts.calib = from_numpy(jax.device_get(js.calib), "cpu")
    ts.window = from_numpy(jax.device_get(js.window), "cpu")
    ts.imm = from_numpy(jax.device_get(js.imm), "cpu")
    ts.shells = [TShell(id=s.id, timestamp=s.timestamp, exposure=s.exposure,
                        cam_to_world=s.cam_to_world.copy(), tracking_ref=s.tracking_ref,
                        cam_to_ref=s.cam_to_ref.copy(), aff=np.array(s.aff))
                 for s in js.shells]
    ts.ref_shell_id, ts.ref_slot = js.ref_shell_id, js.ref_slot
    ts._pc_ring = deque([(sid, t(np.asarray(r))) for sid, r in js._pc_ring], maxlen=8)
    return ts


def _jax_luts(js):
    return [np.asarray(x) for x in (js._inv_response, js._inv_vignette, js._grad_weight)]


def test_pc_sample_matches_jax(jax_state):
    js, saved = jax_state
    _reset_jax(js, saved)
    ts = _port_from(js)
    ref = js.shells[js.ref_shell_id].cam_to_world
    rels = np.stack([np.linalg.inv(js.shells[sid].cam_to_world) @ ref for sid, _ in js._pc_ring])
    tpl = js.template
    K4 = jnp.asarray([js.calib.value[i] for i in range(4)])
    a = js._pc_sample(tpl.u[0], tpl.v[0], tpl.idepth[0], tpl.valid[0], K4,
                      jnp.asarray(rels[:, :3, :3], jnp.float32),
                      jnp.asarray(rels[:, :3, 3], jnp.float32),
                      jnp.stack([r for _, r in js._pc_ring]))
    tt = ts.template
    b = ts._pc_sample(tt.u[0], tt.v[0], tt.idepth[0], tt.valid[0], ts.calib.value[:4],
                      t(rels[:, :3, :3], np.float32), t(rels[:, :3, 3], np.float32),
                      torch.stack([r.to(torch.uint8) for _, r in ts._pc_ring]))
    obs_j, r2_j, mask_j = (np.asarray(x) for x in a)
    obs_t, r2_t, mask_t = (x.numpy() for x in b)
    assert mask_j.sum() > 100
    np.testing.assert_array_equal(mask_t, mask_j)
    assert err(obs_t[mask_j], obs_j[mask_j]) <= 1e-3 and err(r2_t, r2_j) <= 1e-5


def test_first_fit_and_template_resync_match_jax(jax_state):
    """The first fit from the same ring and template: the correction it
    switches on, the template colours it re-corrects, the flag for the
    mapping thread."""
    js, saved = jax_state
    _reset_jax(js, saved)
    ts = _port_from(js)
    js._photo_calib_step()
    ts._photo_calib_step()
    assert ts.n_photo_fits == 1 and ts._pc_window_resync and js._pc_window_resync
    # 20 f32 GN iterations: the inverse response within 5e-3 of 255 levels
    # (measured 6.8e-4), 1/V within 1e-5 (4.8e-7), B' within 1e-3 (1.2e-4)
    inv_r, inv_v, gw = (x.numpy() for x in ts._pc_luts)
    jr, jv, jg = _jax_luts(js)
    assert err(inv_r, jr) <= 5e-3 and err(inv_v, jv) <= 1e-5 and err(gw, jg) <= 1e-3, (
        err(inv_r, jr), err(inv_v, jv), err(gw, jg))
    assert abs(float(ts._pc_rms) - float(js._pc_rms)) <= 1e-5
    for a, b in zip(js.template.color, ts.template.color):
        assert err(a, b) <= 5e-3, err(a, b)


def test_blended_refit_matches_jax(jax_state):
    """The second fit warm-starts from the first (the prior toward it) and
    blends its correction into the applied one at 0.3."""
    js, saved = jax_state
    _reset_jax(js, saved)
    ts = _port_from(js)
    js._photo_calib_step()
    ts._photo_calib_step()
    first = [x.clone() for x in ts._pc_luts]
    # the second fit starts from the JAX package's parameters in both
    ts._pc_params = from_numpy(jax.device_get(js._pc_params), "cpu")
    js._photo_calib_step()
    ts._photo_calib_step()
    assert ts.n_photo_fits == 2 and all(a is not b for a, b in zip(first, ts._pc_luts))
    inv_r, inv_v, gw = (x.numpy() for x in ts._pc_luts)
    jr, jv, jg = _jax_luts(js)
    assert err(inv_r, jr) <= 5e-3 and err(inv_v, jv) <= 1e-5 and err(gw, jg) <= 1e-3, (
        err(inv_r, jr), err(inv_v, jv), err(gw, jg))


def test_resync_state_matches_jax(jax_state):
    """The window half of the first-fit resync (keyframe images with their
    gradients, candidate and point colours) with one correction in both."""
    js, saved = jax_state
    _reset_jax(js, saved)
    ts = _port_from(js)
    _, inv_resp, inv_vig = _luts()
    w, imm = js.window, js.imm
    a = js._pc_resync_state(w.frames.images, imm.color, imm.u, imm.v, w.points.color,
                            w.points.u, w.points.v, jnp.asarray(inv_resp), jnp.asarray(inv_vig))
    tw, ti = ts.window, ts.imm
    b = ts._pc_resync_state(tw.frames.images, ti.color, ti.u, ti.v, tw.points.color,
                            tw.points.u, tw.points.v, t(inv_resp), t(inv_vig))
    for x, y in zip(a, b):
        assert y.shape == x.shape
        assert err(x, y) <= 1e-5 * max(1.0, float(np.abs(np.asarray(x)).max()))
    # and the template half
    c = js._pc_resync_template(js.template, jnp.asarray(inv_resp), jnp.asarray(inv_vig))
    d = ts._pc_resync_template(ts.template, t(inv_resp), t(inv_vig))
    for x, y in zip(c.color, d.color):
        assert err(x, y) <= 1e-5 * max(1.0, float(np.abs(np.asarray(x)).max()))


def _cal_inputs():
    rng = np.random.default_rng(5)
    raw = rng.uniform(10.0, 245.0, (H, W)).astype(np.float32)
    x = np.arange(256, dtype=np.float32)
    inv_resp = (255.0 * (x / 255.0) ** 1.4).astype(np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    r2 = (((xs - W / 2) ** 2 + (ys - H / 2) ** 2) / ((W / 2) ** 2 + (H / 2) ** 2))
    inv_vig = (1.0 / (1.0 - 0.3 * r2)).astype(np.float32)
    grad_w = (0.5 + x / 510.0).astype(np.float32)
    return raw, inv_resp, inv_vig, grad_w


def test_calibrated_pyramid_matches_jax():
    """The correction fused into the pyramid call: values past 255 (1/V up
    to 1.43) through the clamped gamma-weight index."""
    raw, inv_resp, inv_vig, grad_w = _cal_inputs()
    js = JSLAM(FX, FX, CX, CY, W, H, JConfig(**CFG_KW), online_photo_calib=True,
               enable_loop_closure=False)
    ts = SLAMSystem(FX, FX, CX, CY, W, H, Config(**CFG_KW), online_photo_calib=True,
                    enable_loop_closure=False, device="cpu")
    pj, gj = js._prep_calibrated(jnp.asarray(raw), jnp.asarray(inv_resp), jnp.asarray(inv_vig),
                                 jnp.asarray(grad_w))
    pt, gt_ = ts._prep_calibrated(t(raw), t(inv_resp), t(inv_vig), t(grad_w))
    assert float(pt[0][..., 0].max()) > 255.0
    for a, b in zip(pj + gj, pt + gt_):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-3)


def test_pipelined_path_matches_sequential_pyramids():
    """tests/test_photo_calib.py::test_pipelined_path_matches_sequential_pyramids
    on the port: the sequential entry's calibrated pyramid and the pipelined
    entry's (the correction, then track_step with the gradient weight) are
    the same, and the gamma re-weighting bites."""
    Hs, Ws = 64, 96
    cfg = Config(max_frames=4, max_points=64, max_immature=64, max_features=64, pyr_levels=3)
    ts = SLAMSystem(80.0, 80.0, Ws / 2 - 0.5, Hs / 2 - 0.5, Ws, Hs, cfg, online_photo_calib=True,
                    enable_loop_closure=False, device="cpu")
    rng = np.random.default_rng(5)
    raw = t(rng.uniform(10.0, 245.0, (Hs, Ws)), np.float32)
    x = torch.arange(256, dtype=torch.float32)
    inv_resp = 255.0 * (x / 255.0) ** 1.4
    ys, xs = torch.meshgrid(torch.arange(Hs), torch.arange(Ws), indexing="ij")
    r2 = ((xs - Ws / 2) ** 2 + (ys - Hs / 2) ** 2) / ((Ws / 2) ** 2 + (Hs / 2) ** 2)
    inv_vig = (1.0 / (1.0 - 0.3 * r2)).float()
    grad_w = 0.5 + x / 510.0
    pyr_s, grads_s = ts._prep_calibrated(raw, inv_resp, inv_vig, grad_w)
    pts = 32
    ts.template = trk.build_template(
        torch.linspace(5, Ws - 5, pts), torch.linspace(5, Hs - 5, pts), torch.full((pts,), 0.5),
        torch.ones(pts), torch.ones(pts, dtype=torch.bool), pyr_s)
    ts._pc_luts = (inv_resp, inv_vig, grad_w)
    eye = torch.eye(4)
    out = ts._track_step(raw.to(torch.uint8), eye, eye, eye, False, torch.zeros(2), 1.0, 1.0)
    raw8 = raw.to(torch.uint8).float()
    pyr_8, grads_8 = ts._prep_calibrated(raw8, inv_resp, inv_vig, grad_w)
    for a, b in zip(pyr_8 + grads_8, out.pyr + out.grads):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    _, grads_u = ts._prep_calibrated(raw, inv_resp, inv_vig, torch.ones(256))
    assert float((grads_u[0] - grads_s[0]).abs().max()) > 1e-3
    ts.close()


# --------------------------------------------------------------- live runs
def test_online_calibration_in_live_system():
    """tests/test_photo_calib.py::test_online_calibration_in_live_system on
    the port, same frames: 20 raw frames through gamma 0.7, vignette
    1 - 0.30 r^2 and exposure flicker with the telemetry passed, sequential,
    a fit every 6 frames. The fitted response must de-gamma better than
    identity and stay monotone, the vignette darken the corners, tracking
    hold (ATE under 0.2)."""
    from hslam_tpu.utils import lie
    from test_system import CX as JCX, CY as JCY, H as JH, W as JW, FX as JFX, make_texture, render
    slam = SLAMSystem(JFX, JFX, JCX, JCY, JW, JH, Config(**CFG_KW), online_photo_calib=True,
                      photo_calib_every=6, enable_loop_closure=False, device="cpu")
    I0 = make_texture()
    ys, xs = np.mgrid[0:JH, 0:JW]
    vig = 1.0 - 0.30 * ((xs - JCX) ** 2 + (ys - JCY) ** 2) / (JCX ** 2 + JCY ** 2)
    gt = []
    for i in range(20):
        ti = i / 10.0
        R, tt = lie.se3_exp(jnp.array([0.5 * np.sin(0.3 * ti), 0.3 * (1 - np.cos(0.35 * ti)),
                                       0.15 * np.sin(0.2 * ti), 0.03 * np.sin(0.25 * ti),
                                       0.03 * (1 - np.cos(0.2 * ti)), 0.02 * ti]))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = np.asarray(R), np.asarray(tt)
        gt.append(np.linalg.inv(T)[:3, 3])
        e = 1.0 + 0.15 * np.sin(0.9 * i)
        raw = 255.0 * np.clip(vig * e * np.asarray(render(I0, R, tt)) / 255.0, 0, 1) ** 0.7
        slam.process_frame(raw.astype(np.float32), ti, exposure=e)
        assert not slam.is_lost, f"lost at frame {i}"
    assert slam.initialized and slam.n_photo_fits >= 1 and slam._pc_luts is not None
    assert math.isfinite(float(slam._pc_rms))
    lut = TPC.gamma_lut(slam._pc_params).numpy()
    x = np.arange(256.0)
    truth = 255.0 * (x / 255.0) ** 0.7
    err_est, err_id = np.sqrt(np.mean((lut - truth) ** 2)), np.sqrt(np.mean((x - truth) ** 2))
    assert err_est < 0.6 * err_id, (err_est, err_id)
    assert (np.diff(lut) >= -1e-3).all()
    vm = TPC.vignette_map(slam._pc_params, JH, JW).numpy()
    assert vm[JH // 2, JW // 2] > vm[0, 0], "vignette corners not darker"
    err = ate_rmse(np.array(gt), np.array([s.cam_to_world[:3, 3] for s in slam.shells]))
    assert np.isfinite(err) and err < 0.2, err


@pytest.mark.slow
def test_online_calibration_improves_ate():
    """tests/test_photo_calib.py::test_online_calibration_improves_ate on the
    port, same frames (its texture and renderer): 60 frames through an
    unmodelled gamma 0.7, vignette 1 - 0.45 r^2 and exposure flicker,
    sequential; with the calibrator the ATE must be below 0.8x the ATE
    without."""
    from hslam_tpu.utils import lie
    from test_system import CX as JCX, CY as JCY, H as JH, W as JW, FX as JFX, make_texture, render
    ys, xs = np.mgrid[0:JH, 0:JW]
    vig = 1.0 - 0.45 * ((xs - JCX) ** 2 + (ys - JCY) ** 2) / (JCX ** 2 + JCY ** 2)
    I0 = make_texture()
    frames, exps, gts = [], [], []
    for i in range(60):
        ti = i * 0.05
        R, tt = lie.se3_exp(jnp.array([0.35 * np.sin(0.25 * ti), 0.22 * (1 - np.cos(0.3 * ti)),
                                       0.10 * np.sin(0.17 * ti), 0.02 * np.sin(0.2 * ti),
                                       0.02 * (1 - np.cos(0.15 * ti)), 0.01 * ti]))
        e = 1.0 + 0.35 * np.sin(0.45 * i)
        raw = 255.0 * np.clip(e * vig * np.asarray(render(I0, R, tt)) / 255.0, 0, 1) ** 0.7
        frames.append(np.clip(np.round(raw), 0, 255).astype(np.uint8))
        exps.append(e)
        gts.append(np.asarray(tt, np.float64))
    gts = np.stack(gts)

    def run(enable):
        slam = SLAMSystem(JFX, JFX, JCX, JCY, JW, JH, Config(**CFG_KW), online_photo_calib=enable,
                          photo_calib_every=8, enable_loop_closure=False, device="cpu")
        for i, f in enumerate(frames):
            slam.process_frame(f, i * 0.05, exposure=exps[i])
        slam.close()
        assert slam.initialized
        v = [s.id for s in slam.shells if s.pose_valid]
        # the JAX test's metric: against the worldToCam translations
        return slam, ate_rmse(gts[v], np.array([slam.shells[i].cam_to_world[:3, 3] for i in v]))

    _, ate_off = run(False)
    slam, ate_on = run(True)
    assert slam.n_photo_fits >= 1 and math.isfinite(float(slam._pc_rms))
    assert ate_on < 0.8 * ate_off, (ate_on, ate_off)


# The JAX package (XLA:CPU) on chip_smoke.py's phase 12: bench.py's photocal
# phase, 72 frames of io/synthetic.make_photocal_frames at 640x480, bench.py's
# capacities, the pipelined entry with the mapping thread, no loop closure,
# without and with the calibrator (a fit every 8 frames). chip_smoke.py
# hard-codes these as JAX_CPU_PHOTOCAL, its bars.
JAX_PHOTOCAL = dict(frames=72, ate_off=0.007532983677308477, valid_off=72, keyframes_off=12,
                    ate_on=0.008458447826464335, valid_on=72, keyframes_on=12,
                    err_est=3.4370534879746852)


@pytest.mark.slow
def test_photocal_sequence_jax_reference():
    """Recompute JAX_PHOTOCAL. The pipelined keyframes depend on thread
    timing (ROADMAP C7), so they are held to +-2 and the calibrated ATE to
    25%; the uncalibrated run's ATE moved more than that between two runs
    of one code (0.0075 and 0.0126, CPU), so it is held only to the bar of
    0.02 that phase 12 applies."""
    from hslam_tpu.models import photo_calib as jpc
    Hf, Wf, F0 = 480, 640, 320.0
    frames, exps, centres = make_photocal_frames(Scene(Hf, Wf, F0), 72)
    got = {}
    for enable, tag in ((False, "off"), (True, "on")):
        js = JSLAM(F0, F0, Wf / 2 - 0.5, Hf / 2 - 0.5, Wf, Hf,
                   JConfig(max_frames=8, max_points=2048, max_immature=2048, pyr_levels=6),
                   sequential=False, online_photo_calib=enable, photo_calib_every=8,
                   enable_loop_closure=False)
        for i, f in enumerate(frames):
            js.process_frame_pipelined(f, 0.05 * i, exposure=exps[i])
        js.flush_pipeline()
        js.finish()
        js.close()
        valid = [s.id for s in js.shells if s.pose_valid]
        got["ate_" + tag] = ate_rmse(centres[valid], np.array(
            [js.shells[i].cam_to_world[:3, 3] for i in valid]))
        got["valid_" + tag], got["keyframes_" + tag] = len(valid), js.next_kf_id
    x = np.arange(256.0)
    got["err_est"] = float(np.sqrt(np.mean(
        (np.asarray(jpc.gamma_lut(js._pc_params)) - 255.0 * (x / 255.0) ** 0.7) ** 2)))
    print(got)
    ref = JAX_PHOTOCAL
    for tag in ("off", "on"):
        assert got["valid_" + tag] == ref["valid_" + tag]
        assert abs(got["keyframes_" + tag] - ref["keyframes_" + tag]) <= 2
    assert abs(got["ate_on"] - ref["ate_on"]) <= 0.25 * ref["ate_on"] and got["ate_off"] < 0.02
    assert abs(got["err_est"] - ref["err_est"]) <= 0.25 * ref["err_est"]
