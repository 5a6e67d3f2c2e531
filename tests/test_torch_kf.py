"""The keyframe-path modules of hslam_tpu_torch against the JAX package:
selector (with the JAX draws fed in), distance map, epipolar trace,
activation, two-view (with the JAX RANSAC samples fed in), indirect
association, the keypoint-hosted candidate insert, and whole kf_steps
(direct-only and hybrid) from the same state, KFBundle compared field by
field.

The kf_step comparison patches the JAX package's `scatter_update` inside
this test with the documented "j-th valid candidate -> j-th free slot"
write (fault C1, see test_torch_utils.py); the package's files are not
touched. Without the patch, its inserts are lost and no field could agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.config import Config as JConfig
from hslam_tpu.models import calib as jcalib
from hslam_tpu.models import kf_step as jks
from hslam_tpu.models import window as jw
from hslam_tpu.ops import activation as jact
from hslam_tpu.ops import distmap as jdist
from hslam_tpu.ops import epipolar as jepi
from hslam_tpu.ops import features as jft
from hslam_tpu.ops import selector as jsel
from hslam_tpu.ops import tracker as jtrk
from hslam_tpu.ops import twoview as jtv
from hslam_tpu.ops.pyramid import build_direct_pyramid as jpyr
from hslam_tpu_torch.config import Config
from hslam_tpu_torch.convert import to_numpy
from hslam_tpu_torch.io.synthetic import Scene, make_sequence, se3_exp_np, sweep_xi
from hslam_tpu_torch.models import kf_step as tks
from hslam_tpu_torch.models.system import SLAMSystem
from hslam_tpu_torch.ops import activation as tact
from hslam_tpu_torch.ops import distmap as tdist
from hslam_tpu_torch.ops import epipolar as tepi
from hslam_tpu_torch.ops import selector as tsel
from hslam_tpu_torch.ops import twoview as ttv
from hslam_tpu_torch.ops.pyramid import build_direct_pyramid

torch.set_num_threads(1)

H, W, FX = 96, 128, 80.0
CFG_KW = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=400.0, desired_immature_density=300.0,
              tracker_iters_per_level=(6, 10, 10), enable_indirect=False,
              init_direct_refine=False)
CFG, JCFG = Config(**CFG_KW), JConfig(**CFG_KW)

_JAX_TYPES = {c.__name__: c for c in (jw.Window, jw.Frames, jw.Points, jks.Imm,
                                      jepi.TraceState, jtrk.Template, jcalib.Calib,
                                      jft.Feats)}


def to_jax(tree):
    """Port structure -> the JAX package's structure of the same name."""
    tree = to_numpy(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return _JAX_TYPES[type(tree).__name__](
            **{k: to_jax(getattr(tree, k)) for k in tree._fields})
    if isinstance(tree, list):
        return [to_jax(x) for x in tree]
    if isinstance(tree, np.ndarray):
        return jnp.asarray(tree)
    return tree


def _t(x):
    return torch.from_numpy(np.array(x))


def _n(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def frame_pyr():
    img = Scene(H, W, FX, n_blobs=16).render(np.eye(3), np.zeros(3))
    pyr, grads = jpyr(jnp.asarray(img), 3)
    return [_n(p) for p in pyr], [_n(g) for g in grads]


@pytest.mark.parametrize("pot", [3, 5])
def test_selector_matches_with_jax_draws(frame_pyr, pot):
    pyr, grads = frame_pyr
    seed = 4
    blk4 = 4 * pot
    Hp, Wp = -(-H // blk4) * blk4, -(-W // blk4) * blk4
    draws = []
    for salt, blk in enumerate((pot, 2 * pot, 4 * pot)):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), salt), seed)
        draws.append(_t(_n(jax.random.randint(k, (Hp // blk, Wp // blk), 0, 16))))
    js = jsel.select_pixels(jnp.asarray(pyr[0]), tuple(jnp.asarray(g) for g in grads),
                            pot, 1.0, jnp.int32(seed), JCFG)
    ts = tsel.select_pixels(_t(pyr[0]), tuple(_t(g) for g in grads), pot, 1.0, seed, CFG,
                            dir_idx=draws)
    np.testing.assert_array_equal(ts.numpy(), _n(js))
    assert (ts.numpy() > 0).sum() > 50
    rand = _n(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(17), seed), (H * W,)))
    jc = jsel.compact_selection(js, jnp.asarray(grads[0]), 512, jnp.int32(300), jnp.int32(seed))
    tc = tsel.compact_selection(ts, _t(grads[0]), 512, 300, seed, rand=_t(rand))
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), _n(b))


def test_distance_map_matches():
    rng = np.random.default_rng(2)
    su = rng.uniform(-2, 66, 40).astype(np.float32)
    sv = rng.uniform(-2, 50, 40).astype(np.float32)
    ok = rng.uniform(size=40) > 0.3
    jd = jdist.distance_map(jnp.asarray(su), jnp.asarray(sv), jnp.asarray(ok), 48, 64)
    td = tdist.distance_map(_t(su), _t(sv), _t(ok), 48, 64)
    np.testing.assert_array_equal(td.numpy(), _n(jd))


def _trace_setup():
    """tests/test_ops.py::TestEpipolar::test_trace_recovers_depth inputs."""
    sc = Scene(H, W, FX, n_blobs=16)
    img = sc.render(np.eye(3), np.zeros(3))
    R, t = se3_exp_np(np.array([0.12, 0.02, 0.0, 0.0, 0.0, 0.0]))
    tgt = _n(jpyr(jnp.asarray(sc.render(R, t)), 1)[0][0])
    dir0 = _n(jpyr(jnp.asarray(img), 1)[0][0])
    rng = np.random.default_rng(1)
    P = 64
    u = rng.uniform(20, W - 20, P).astype(np.float32)
    v = rng.uniform(20, H - 20, P).astype(np.float32)
    col, wgt, gH, _ = (_n(x) for x in tks.sample_pattern(_t(dir0), _t(u), _t(v), CFG))
    K = np.array([[FX, 0, W / 2 - 0.5], [0, FX, H / 2 - 0.5], [0, 0, 1.0]])
    KRKi = np.broadcast_to(K @ R @ np.linalg.inv(K), (P, 3, 3)).astype(np.float32)
    Kt = np.broadcast_to(K @ t, (P, 3)).astype(np.float32)
    aff = np.broadcast_to(np.array([1.0, 0.0], np.float32), (P, 2))
    eth = np.full(P, 8 * CFG.outlier_th, np.float32)
    return P, u, v, col, wgt, gH, eth, KRKi, Kt, aff, tgt


def test_trace_on_matches():
    P, u, v, col, wgt, gH, eth, KRKi, Kt, aff, tgt = _trace_setup()
    args = (u, v, col, wgt, gH, eth, np.ones(P, bool), KRKi, Kt, aff, tgt)
    js = jepi.trace_on(jepi.init_trace_state(P), *(jnp.asarray(a) for a in args), JCFG)
    ts = tepi.trace_on(tepi.init_trace_state(P, "cpu"), *(_t(a) for a in args), CFG)
    # a second pass from the traced state exercises the known-interval branch
    js2 = jepi.trace_on(js, *(jnp.asarray(a) for a in args), JCFG)
    ts2 = tepi.trace_on(ts, *(_t(a) for a in args), CFG)
    assert (_n(js.status) == jepi.IPS_GOOD).sum() > P // 3
    for j, t in ((js, ts), (js2, ts2)):
        np.testing.assert_array_equal(t.status.numpy(), _n(j.status))
        good = _n(j.status) == jepi.IPS_GOOD
        for name in ("idepth_min", "idepth_max", "last_u", "last_v", "last_interval"):
            # sub-pixel GN along the line on the same samples: f32 agreement
            np.testing.assert_allclose(getattr(t, name).numpy()[good], _n(getattr(j, name))[good],
                                       rtol=1e-4, atol=1e-4, err_msg=name)


def test_two_view_matches_with_jax_samples():
    """tests/test_ops.py::TestTwoView::test_reconstruct_known_motion inputs."""
    key = jax.random.PRNGKey(0)
    N = 200
    f, cx, cy = 100.0, 63.5, 47.5
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]], np.float32)
    X = np.stack([_n(jax.random.uniform(key, (N,), minval=-1.5, maxval=1.5)),
                  _n(jax.random.uniform(jax.random.fold_in(key, 1), (N,), minval=-1.0, maxval=1.0)),
                  _n(jax.random.uniform(jax.random.fold_in(key, 2), (N,), minval=2.0, maxval=6.0))], -1)
    R, t = se3_exp_np(np.array([0.3, 0.05, 0.05, 0.02, -0.04, 0.01]))
    X2 = X @ R.T + t
    p1 = np.stack([f * X[:, 0] / X[:, 2] + cx, f * X[:, 1] / X[:, 2] + cy], -1).astype(np.float32)
    p2 = (np.stack([f * X2[:, 0] / X2[:, 2] + cx, f * X2[:, 1] / X2[:, 2] + cy], -1)
          + _n(jax.random.normal(jax.random.fold_in(key, 3), (N, 2))) * 0.3).astype(np.float32)
    valid = np.ones(N, bool)
    jkey = jax.random.PRNGKey(7)
    samples = _n(jax.random.choice(jkey, N, shape=(150, 8), p=jnp.asarray(valid / N)))
    jr = jtv.two_view_reconstruct(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                  jnp.asarray(K), jkey, n_iters=150)
    tr = ttv.two_view_reconstruct(_t(p1), _t(p2), _t(valid), _t(K), n_iters=150,
                                  samples=_t(samples).long())
    assert bool(tr.ok) and bool(jr.ok)
    assert bool(tr.is_H) == bool(jr.is_H)
    np.testing.assert_array_equal(tr.inliers.numpy(), _n(jr.inliers))
    # SVD signs differ between the libraries: compare sign-invariant results
    np.testing.assert_allclose(tr.R.numpy(), _n(jr.R), atol=2e-3)
    tj, tt = _n(jr.t), tr.t.numpy()
    assert min(np.abs(tt - tj).max(), np.abs(tt + tj).max()) < 2e-3
    agree = np.mean(tr.tri_ok.numpy() == _n(jr.tri_ok))
    assert agree > 0.97, agree
    both = tr.tri_ok.numpy() & _n(jr.tri_ok)
    np.testing.assert_allclose(tr.points3d.numpy()[both], _n(jr.points3d)[both], rtol=2e-2)
    # and the port recovers the motion on its own RNG too (outcome, C3)
    own = ttv.two_view_reconstruct(_t(p1), _t(p2), _t(valid), _t(K), seed=7, n_iters=150)
    assert bool(own.ok)
    dR = own.R.numpy() @ R.T
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 0.02


def _documented_scatter_update(arr, slots, write, values):
    """The JAX-side stand-in for compaction.scatter_update with fault C1
    repaired: unwritten candidates go to a dropped scratch row."""
    S = arr.shape[0]
    ext = jnp.concatenate([arr, arr[:1]], axis=0)
    idx = jnp.where(write, slots, S)
    return ext.at[idx].set(values.astype(arr.dtype))[:S]


def _jax_kf_step(*args, cfg, **kw):
    """The JAX package's kf_step inside one jit, as its system runs it (a
    fresh function each call, so no trace made under a test's patch is
    shared with another caller)."""
    return jax.jit(lambda *a, **k: jks.kf_step(*a, cfg=cfg, **k))(*args, **kw)


@pytest.fixture(scope="module")
def kf_state():
    """A port-made state one frame before a keyframe step (frame 9 of the
    sweep), plus the step's inputs."""
    frames, _ = make_sequence(Scene(H, W, FX, n_blobs=16), 10, lambda i: sweep_xi(i / 10.0))
    slam = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, CFG, enable_loop_closure=False,
                      device="cpu")
    for i, f in enumerate(frames[:9]):
        slam.process_frame(f, 0.1 * i)
    assert slam.initialized and slam.next_kf_id >= 3
    pyr, grads = build_direct_pyramid(_t(frames[9]), 3)
    shell = slam.shells[-1]
    Twc = np.linalg.inv(shell.cam_to_world)
    flag = np.zeros(CFG.max_frames, bool)
    flag[slam._flag_frames_for_marg(shell)] = True
    slot = int(np.flatnonzero(~slam._m_valid)[0])
    sel = slam._select_px(slam.selector_pot, pyr[0], grads, 300, 9)
    return dict(slam=slam, pyr=pyr, R=Twc[:3, :3].astype(np.float32),
                t=Twc[:3, 3].astype(np.float32), aff=shell.aff.astype(np.float32),
                slot=slot, flag=flag, sel=sel)


def test_activation_matches(kf_state):
    slam = kf_state["slam"]
    imm = slam.imm
    idm = 0.5 * (imm.trace.idepth_max + imm.trace.idepth_min)
    cand = imm.valid & torch.isfinite(idm) & (imm.trace.status == tepi.IPS_GOOD)
    assert int(cand.sum()) > 20
    args = (imm.u, imm.v, idm, imm.color, imm.weight, imm.host, cand)
    ja = jact.activate_points(to_jax(slam.window.frames), to_jax(slam.calib),
                              *(to_jax(a) for a in args), cfg=JCFG)
    ta = tact.activate_points(slam.window.frames, slam.calib, *args, cfg=CFG)
    np.testing.assert_array_equal(ta.ok.numpy(), _n(ja.ok))
    np.testing.assert_array_equal(ta.res_in.numpy(), _n(ja.res_in))
    ok = _n(ja.ok)
    assert ok.sum() > 10
    # 3 idepth LM steps from the same start on the same samples; each step
    # divides f32 sums taken in another order: agreement ~1e-4 relative
    np.testing.assert_allclose(ta.idepth.numpy()[ok], _n(ja.idepth)[ok], rtol=5e-4)


def test_kf_step_bundle_matches(kf_state, monkeypatch):
    monkeypatch.setattr(jks, "scatter_update", _documented_scatter_update)
    s = kf_state
    slam = s["slam"]
    common = dict(slot=s["slot"], kf_id=slam.next_kf_id, ref_slot=slam.ref_slot,
                  act_dist=float(slam.current_min_act_dist), n_iter=6)
    sel_t = s["sel"]
    tout = tks.kf_step(slam.window, slam.calib, slam.imm, slam.feats, s["pyr"], _t(s["R"]),
                       _t(s["t"]),
                       _t(s["aff"]), torch.tensor(1.0), common["slot"], common["kf_id"],
                       common["ref_slot"], s["flag"], common["act_dist"], 6, *sel_t, CFG)
    jout = _jax_kf_step(
        to_jax(slam.window), to_jax(slam.calib), to_jax(slam.imm),
        jft.empty_feats(CFG.max_frames, CFG.max_kf_features),
        [jnp.asarray(_n(p)) for p in s["pyr"]],
        jnp.asarray(s["R"]), jnp.asarray(s["t"]), jnp.asarray(s["aff"]), jnp.float32(1.0),
        jnp.int32(common["slot"]), jnp.int32(common["kf_id"]), jnp.int32(common["ref_slot"]),
        jnp.asarray(s["flag"]), jnp.float32(common["act_dist"]), jnp.int32(6),
        *(to_jax(x) for x in sel_t), cfg=JCFG)
    tb, jb = to_numpy(tout[-1]), jax.device_get(jout[-1])
    exact = ("valid", "kf_id", "exposure", "n_active", "n_active_host", "n_imm_host",
             "sel_count", "removed_host", "conn_active", "conn_marg", "flow_ok", "n_ind")
    for name in exact:
        np.testing.assert_array_equal(getattr(tb, name), _n(getattr(jb, name)), err_msg=name)
    assert int(tb.n_active) > 100
    # BA over the same residual set (counts above are exact); the f32 window
    # solve's gauge sensitivity bounds the poses (see test_torch_ba.py)
    np.testing.assert_allclose(tb.rmse, _n(jb.rmse), rtol=1e-3)
    np.testing.assert_allclose(tb.Rwc, _n(jb.Rwc), atol=2e-4)
    np.testing.assert_allclose(tb.twc, _n(jb.twc), atol=2e-4)
    np.testing.assert_allclose(tb.aff, _n(jb.aff), atol=1e-3)
    np.testing.assert_allclose(tb.calib_value, _n(jb.calib_value), rtol=1e-5)
    # the new tracking template: same pixels, same depths
    tt, jt = to_numpy(tout[4]), jax.device_get(jout[4])
    for lvl in range(CFG.pyr_levels):
        np.testing.assert_array_equal(tt.valid[lvl], _n(jt.valid[lvl]))
        np.testing.assert_array_equal(tt.u[lvl], _n(jt.u[lvl]))
        m = _n(jt.valid[lvl])
        np.testing.assert_allclose(tt.idepth[lvl][m], _n(jt.idepth[lvl])[m], rtol=2e-3)


# ---------------------------------------------------------------- hybrid layer
CFG_H_KW = dict(CFG_KW, enable_indirect=True, init_direct_refine=True)
CFG_H, JCFG_H = Config(**CFG_H_KW), JConfig(**CFG_H_KW)


@pytest.fixture(scope="module")
def hybrid_state():
    """A port-made hybrid state (the default indirect layer and init
    refinement) one frame before a keyframe step, plus the step's inputs."""
    frames, _ = make_sequence(Scene(H, W, FX, n_blobs=16), 10, lambda i: sweep_xi(i / 10.0))
    slam = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, CFG_H, enable_loop_closure=False,
                      device="cpu")
    for i, f in enumerate(frames[:9]):
        slam.process_frame(f, 0.1 * i)
    assert slam.initialized and slam.next_kf_id >= 3
    assert sum(slam.ind_obs_history) > 0
    pyr, grads = build_direct_pyramid(_t(frames[9]), 3)
    shell = slam.shells[-1]
    Twc = np.linalg.inv(shell.cam_to_world)
    flag = np.zeros(CFG.max_frames, bool)
    flag[slam._flag_frames_for_marg(shell)] = True
    slot = int(np.flatnonzero(~slam._m_valid)[0])
    sel = slam._select_px(slam.selector_pot, pyr[0], grads, 300, 9)
    return dict(slam=slam, pyr=pyr, R=Twc[:3, :3].astype(np.float32),
                t=Twc[:3, 3].astype(np.float32), aff=shell.aff.astype(np.float32),
                slot=slot, flag=flag, sel=sel)


@pytest.mark.parametrize("w_scale", [None, 2.5], ids=["unscaled", "scaled"])
def test_indirect_associate_matches(hybrid_state, w_scale):
    slam = hybrid_state["slam"]
    slot = slam.ref_slot
    jw_ = jks.indirect_associate(to_jax(slam.window), to_jax(slam.feats), jnp.int32(slot), JCFG_H,
                                 ind_w_scale=None if w_scale is None else jnp.float32(w_scale))
    tw = tks.indirect_associate(slam.window, slam.feats, slot, CFG_H, ind_w_scale=w_scale)
    jp, tp = jax.device_get(jw_.points), to_numpy(tw.points)
    assert jp.ind_valid[:, slot].sum() > 10
    np.testing.assert_array_equal(tp.ind_valid, jp.ind_valid)
    np.testing.assert_array_equal(tp.ind_u, jp.ind_u)
    np.testing.assert_array_equal(tp.ind_v, jp.ind_v)
    # weight / 1.2 ** (2 level): a power evaluated by each library
    np.testing.assert_allclose(tp.ind_w, jp.ind_w, rtol=1e-6)


def test_insert_keypoint_hosted_traces(monkeypatch):
    """Keypoint-hosted candidates carry their keypoint index; selector picks
    carry -1; invalid ones are skipped (with C1 repaired on the JAX side)."""
    monkeypatch.setattr(jks, "scatter_update", _documented_scatter_update)
    img = Scene(H, W, FX, n_blobs=16).render(np.eye(3), np.zeros(3))
    dir0 = _n(jpyr(jnp.asarray(img), 1)[0][0])
    rng = np.random.default_rng(8)
    C = 40
    u = rng.uniform(10, W - 10, C).astype(np.float32)
    v = rng.uniform(10, H - 10, C).astype(np.float32)
    typ = np.ones(C, np.int32)
    valid = rng.uniform(size=C) > 0.3
    kp = np.where(np.arange(C) < 25, np.arange(C), -1).astype(np.int32)
    args = (u, v, typ, valid)
    ji = jks.insert_new_traces(jks.empty_imm(JCFG), jnp.int32(2), *(jnp.asarray(a) for a in args),
                               jnp.asarray(dir0), JCFG, sel_kp=jnp.asarray(kp))
    ti = tks.insert_new_traces(tks.empty_imm(CFG, "cpu"), 2, *(_t(a) for a in args), _t(dir0), CFG,
                               sel_kp=_t(kp))
    np.testing.assert_array_equal(ti.valid.numpy(), _n(ji.valid))
    np.testing.assert_array_equal(ti.kp_idx.numpy(), _n(ji.kp_idx))
    np.testing.assert_array_equal(ti.u.numpy(), _n(ji.u))
    n = int(valid.sum())
    np.testing.assert_array_equal(ti.kp_idx.numpy()[:n], kp[valid])
    np.testing.assert_array_equal(ti.host.numpy()[:n], 2)


def test_kf_step_hybrid_bundle_matches(hybrid_state, monkeypatch):
    """One hybrid kf_step from the same converted state: feature extraction,
    indirect association (n_ind), keypoint-hosted inserts and the keypoint
    depth lift agree exactly; the BA (now with indirect factors) to the
    tolerances of the direct-only test."""
    monkeypatch.setattr(jks, "scatter_update", _documented_scatter_update)
    s = hybrid_state
    slam = s["slam"]
    slot, kf_id, ref_slot = s["slot"], slam.next_kf_id, slam.ref_slot
    act = float(slam.current_min_act_dist)
    tout = tks.kf_step(slam.window, slam.calib, slam.imm, slam.feats, s["pyr"], _t(s["R"]),
                       _t(s["t"]), _t(s["aff"]), torch.tensor(1.0), slot, kf_id, ref_slot,
                       s["flag"], act, 6, *s["sel"], CFG_H, ind_w_scale=1.5)
    jout = _jax_kf_step(
        to_jax(slam.window), to_jax(slam.calib), to_jax(slam.imm), to_jax(slam.feats),
        [jnp.asarray(_n(p)) for p in s["pyr"]], jnp.asarray(s["R"]), jnp.asarray(s["t"]),
        jnp.asarray(s["aff"]), jnp.float32(1.0), jnp.int32(slot), jnp.int32(kf_id),
        jnp.int32(ref_slot), jnp.asarray(s["flag"]), jnp.float32(act), jnp.int32(6),
        *(to_jax(x) for x in s["sel"]), cfg=JCFG_H, ind_w_scale=jnp.float32(1.5))
    tf_, jf_ = to_numpy(tout[3]), jax.device_get(jout[3])
    for name in ("u", "v", "level", "desc", "valid"):
        np.testing.assert_array_equal(getattr(tf_, name)[slot], getattr(jf_, name)[slot],
                                      err_msg=name)
    # scores at resized pyramid levels carry the resize's f32 differences
    np.testing.assert_allclose(tf_.score[slot], jf_.score[slot], rtol=1e-6)
    tb, jb = to_numpy(tout[-1]), jax.device_get(jout[-1])
    exact = ("valid", "kf_id", "n_active", "n_active_host", "n_imm_host", "sel_count",
             "removed_host", "conn_active", "conn_marg", "n_ind", "kp_depth_ok")
    for name in exact:
        np.testing.assert_array_equal(getattr(tb, name), _n(getattr(jb, name)), err_msg=name)
    assert int(tb.n_ind) > 10
    m = _n(jb.kp_depth_ok)
    assert m.sum() > 10
    np.testing.assert_allclose(tb.kp_idepth[m], _n(jb.kp_idepth)[m], rtol=2e-3)
    np.testing.assert_allclose(tb.rmse, _n(jb.rmse), rtol=1e-3)
    np.testing.assert_allclose(tb.twc, _n(jb.twc), atol=2e-4)
    ti, ji = to_numpy(tout[2]), jax.device_get(jout[2])
    np.testing.assert_array_equal(ti.valid, ji.valid)
    np.testing.assert_array_equal(ti.kp_idx, ji.kp_idx)
    assert (ti.kp_idx[ti.valid & (ti.host == slot)] >= 0).sum() > 10
