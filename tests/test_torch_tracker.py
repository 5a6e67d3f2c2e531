"""hslam_tpu_torch.ops.tracker and ops.klt against the JAX package, from the
same numpy inputs: template build, one residual pass, batched hypothesis
scoring, the full coarse-to-fine track, and KLT's pure-translation case."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.config import Config as JConfig
from hslam_tpu.ops import klt as jklt
from hslam_tpu.ops import tracker as jtrk
from hslam_tpu.ops.pyramid import build_direct_pyramid as jpyr
from hslam_tpu.ops.pyramid import downsample2 as jdown
from hslam_tpu.utils.interp import pack_cells
from hslam_tpu_torch.config import Config
from hslam_tpu_torch.convert import from_numpy
from hslam_tpu_torch.io.synthetic import Scene, se3_exp_np
from hslam_tpu_torch.ops import klt as tklt
from hslam_tpu_torch.ops import tracker as ttrk
from hslam_tpu_torch.utils.segsum import bin_sums

torch.set_num_threads(1)

H, W, FX = 96, 128, 80.0
LEVELS = 3
CFG_KW = dict(tracker_iters_per_level=(6, 10, 10), pyr_levels=LEVELS)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _jit(fn, **static):
    """A JAX function inside one jit with its static arguments bound, as
    the JAX package's system runs it (and compiled once, not op by op)."""
    return jax.jit(lambda *a, **k: fn(*a, **static, **k))


@pytest.fixture(scope="module")
def scene():
    sc = Scene(H, W, FX, n_blobs=16)
    ref = sc.render(np.eye(3), np.zeros(3))
    R, t = se3_exp_np(np.array([0.03, -0.01, 0.02, 0.004, -0.006, 0.002]))
    tgt = sc.render(R, t)
    ref_pyr = [np.asarray(x) for x in jpyr(jnp.asarray(ref), LEVELS)[0]]
    tgt_pyr = [np.asarray(x) for x in jpyr(jnp.asarray(tgt), LEVELS)[0]]
    # template points: a jittered grid on the plane (idepth 1/2 everywhere)
    rng = np.random.default_rng(4)
    gy, gx = np.mgrid[6:H - 6:3, 6:W - 6:3]
    u = (gx.ravel() + rng.uniform(-0.4, 0.4, gx.size)).astype(np.float32)
    v = (gy.ravel() + rng.uniform(-0.4, 0.4, gy.size)).astype(np.float32)
    idepth = np.full(u.shape, 0.5, np.float32)
    weight = rng.uniform(0.5, 2.0, u.shape).astype(np.float32)
    valid = rng.uniform(size=u.shape) > 0.2
    K = np.array([FX, FX, W / 2 - 0.5, H / 2 - 0.5], np.float32)
    s = 0.5 ** np.arange(LEVELS, dtype=np.float32)
    K_pyr = np.stack([K[0] * s, K[1] * s, (K[2] + 0.5) * s - 0.5, (K[3] + 0.5) * s - 0.5], -1)
    jt = jtrk.build_template(*(jnp.asarray(x) for x in (u, v, idepth, weight, valid)),
                             [jnp.asarray(p) for p in ref_pyr])
    return dict(u=u, v=v, idepth=idepth, weight=weight, valid=valid, ref_pyr=ref_pyr,
                tgt_pyr=tgt_pyr, K_pyr=K_pyr, R=R.astype(np.float32),
                t=t.astype(np.float32), jtemplate=jt)


def test_build_template_matches(scene):
    tt = ttrk.build_template(_t(scene["u"]), _t(scene["v"]), _t(scene["idepth"]),
                             _t(scene["weight"]), _t(scene["valid"]),
                             [_t(p) for p in scene["ref_pyr"]])
    jt = scene["jtemplate"]
    for lvl in range(LEVELS):
        # identical compaction order (valid pixels first, by index)
        np.testing.assert_array_equal(tt.valid[lvl].numpy(), np.asarray(jt.valid[lvl]))
        np.testing.assert_array_equal(tt.u[lvl].numpy(), np.asarray(jt.u[lvl]))
        np.testing.assert_array_equal(tt.v[lvl].numpy(), np.asarray(jt.v[lvl]))
        m = np.asarray(jt.valid[lvl])
        assert m.sum() > 50
        # weighted means of scatter-added idepths: f32 summation order
        np.testing.assert_allclose(tt.idepth[lvl].numpy()[m], np.asarray(jt.idepth[lvl])[m],
                                   rtol=1e-5)
        np.testing.assert_allclose(tt.color[lvl].numpy(), np.asarray(jt.color[lvl]))


def _port_template(scene):
    return from_numpy(jax_np(scene["jtemplate"]), "cpu")


def jax_np(tree):
    import jax
    return jax.device_get(tree)


@pytest.mark.parametrize("flow", [False, True])
def test_residual_pass_matches(scene, flow):
    lvl = 1
    jt = scene["jtemplate"]
    tt = _port_template(scene)
    img = scene["tgt_pyr"][lvl]
    jpacked = jnp.stack([pack_cells(jnp.asarray(img[..., c])) for c in range(3)], 2)
    R = scene["R"] @ se3_exp_np(np.array([0.0, 0.0, 0.0, 0.003, 0.0, 0.0]))[0].astype(np.float32)
    t = scene["t"] + np.float32(0.004)
    args = (0.95, 3.0, 1.5, 20.0, 9.0)
    ja = jtrk._residual_pass(jt.u[lvl], jt.v[lvl], jt.idepth[lvl], jt.color[lvl], jt.valid[lvl],
                             jpacked, jnp.asarray(scene["K_pyr"][lvl]), jnp.asarray(R),
                             jnp.asarray(t), *[jnp.float32(a) for a in args], flow)
    ta = ttrk._residual_pass(tt.u[lvl], tt.v[lvl], tt.idepth[lvl], tt.color[lvl], tt.valid[lvl],
                             ttrk.pack_pyramid_level(_t(img)), _t(scene["K_pyr"][lvl]),
                             _t(R), _t(t), *[torch.tensor(a) for a in args], flow)
    names = ["E", "n", "nsat", "H", "b", "flowT", "flowRT"]
    for name, a, b in zip(names, ta, ja):
        b = np.asarray(b, np.float64)
        # sums over ~1e3 residuals in another order: f32 relative ~1e-5
        np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(b).max(), 1.0), err_msg=name)


def _hypotheses(scene, n=32):
    rng = np.random.default_rng(9)
    Rs, ts = [], []
    for i in range(n):
        xi = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)]) if i else np.zeros(6)
        R, t = se3_exp_np(xi)
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)


def _track_args(scene):
    Rb, tb = _hypotheses(scene)
    aff0 = np.array([0.01, -2.0], np.float32)
    aff_ref = np.array([0.0, 0.5], np.float32)
    return Rb, tb, aff0, np.float32(1.0), np.float32(1.05), aff_ref


def test_score_hypotheses_match(scene):
    Rb, tb, aff0, e_ref, e_new, aff_ref = _track_args(scene)
    lvl = LEVELS - 1
    js = np.asarray(jtrk.score_hypotheses(
        scene["jtemplate"], jnp.asarray(scene["tgt_pyr"][lvl]), jnp.asarray(scene["K_pyr"][lvl]),
        lvl, jnp.asarray(Rb), jnp.asarray(tb), jnp.asarray(aff0), jnp.float32(e_ref),
        jnp.float32(e_new), jnp.asarray(aff_ref), JConfig(**CFG_KW)))
    ts = ttrk.score_hypotheses(
        _port_template(scene), _t(scene["tgt_pyr"][lvl]), _t(scene["K_pyr"][lvl]), lvl,
        _t(Rb), _t(tb), _t(aff0), torch.tensor(e_ref), torch.tensor(e_new), _t(aff_ref),
        Config(**CFG_KW)).numpy()
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    f = np.isfinite(js)
    # 10 fixed GN steps; accept/reject compares energies that agree to f32
    # summation order, so the scores agree to ~1e-5 relative
    np.testing.assert_allclose(ts[f], js[f], rtol=1e-3)
    assert int(np.argmin(ts)) == int(np.argmin(js))


def test_track_coarse_multi_matches(scene):
    Rb, tb, aff0, e_ref, e_new, aff_ref = _track_args(scene)
    jres, jbest = _jit(jtrk.track_coarse_multi, cfg=JConfig(**CFG_KW))(
        scene["jtemplate"], [jnp.asarray(p) for p in scene["tgt_pyr"]],
        jnp.asarray(scene["K_pyr"]), jnp.asarray(Rb), jnp.asarray(tb), jnp.asarray(aff0),
        jnp.float32(e_ref), jnp.float32(e_new), jnp.asarray(aff_ref))
    tres, tbest = ttrk.track_coarse_multi(
        _port_template(scene), [_t(p) for p in scene["tgt_pyr"]], _t(scene["K_pyr"]),
        _t(Rb), _t(tb), _t(aff0), torch.tensor(e_ref), torch.tensor(e_new), _t(aff_ref),
        Config(**CFG_KW))
    assert int(tbest) == int(jbest)
    assert bool(tres.ok) == bool(jres.ok)
    # converged LM from the same start: the poses agree to the LM's own
    # convergence threshold (1e-3 in scaled units) and far better in practice
    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jres.R), atol=1e-4)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-4)
    np.testing.assert_allclose(tres.aff.numpy(), np.asarray(jres.aff), atol=1e-3)
    np.testing.assert_allclose(tres.residuals.numpy(), np.asarray(jres.residuals), rtol=1e-3)
    np.testing.assert_allclose(tres.flow.numpy(), np.asarray(jres.flow), rtol=1e-3, atol=1e-4)
    # and the track recovers the rendered motion
    np.testing.assert_allclose(tres.t.numpy(), scene["t"], atol=2e-3)


def test_klt_pure_translation():
    """tests/test_ops.py::TestKLT::test_track_pure_translation on the port,
    and the same points through the JAX KLT."""
    from hslam_tpu.utils.interp import bilinear
    from test_ops import checker_image
    img = checker_image(96, 128, seed=2)
    shift = (3.7, -2.3)
    ys, xs = jnp.mgrid[0:96, 0:128]
    img2 = bilinear(img, xs + shift[0], ys + shift[1])
    ref_pyr = [img, jdown(img), jdown(jdown(img))]
    tgt_pyr = [img2, jdown(img2), jdown(jdown(img2))]
    pts = np.array([[40.0, 40.0], [80.0, 50.0], [60.0, 30.0], [30.0, 60.0]], np.float32)
    j_out, j_ok, j_err = jklt.track(ref_pyr, tgt_pyr, jnp.asarray(pts))
    t_out, t_ok, t_err = tklt.track([_t(np.asarray(p)) for p in ref_pyr],
                                    [_t(np.asarray(p)) for p in tgt_pyr], _t(pts))
    assert bool(t_ok.all())
    np.testing.assert_allclose(t_out.numpy() - pts, np.tile([-shift[0], -shift[1]], (4, 1)),
                               atol=0.2)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    # 30 fixed GN steps per level on the same patches: f32 agreement
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-3)
    np.testing.assert_allclose(t_err.numpy(), np.asarray(j_err), atol=1e-3)


def test_nearest_template_depth_matches():
    rng = np.random.default_rng(6)
    ku, kv = (rng.uniform(0, 100, 40).astype(np.float32) for _ in range(2))
    tu, tv = (rng.uniform(0, 100, 300).astype(np.float32) for _ in range(2))
    tid = rng.uniform(0.2, 2.0, 300).astype(np.float32)
    tval = rng.uniform(size=300) > 0.3
    jd, jd2 = jtrk.nearest_template_depth(*(jnp.asarray(x) for x in (ku, kv, tu, tv, tid, tval)))
    td, td2 = ttrk.nearest_template_depth(*(_t(x) for x in (ku, kv, tu, tv, tid, tval)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-6)
    # brute force: the nearest valid point, its depth
    d2 = (ku[:, None] - tu[None]) ** 2 + (kv[:, None] - tv[None]) ** 2
    d2[:, ~tval] = np.inf
    np.testing.assert_array_equal(td.numpy(), tid[np.argmin(d2, 1)])


def _c2w(xi):
    R, t = se3_exp_np(np.asarray(xi, np.float64))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return np.linalg.inv(T).astype(np.float32)


@pytest.mark.parametrize("have_motion,dt_ratio", [(True, 1.0), (True, 2.7), (False, 1.0)],
                         ids=["const", "dt_ratio", "no_motion"])
def test_motion_hypotheses_device_matches(have_motion, dt_ratio):
    ref = _c2w([0.01, 0.0, 0.0, 0.0, 0.01, 0.0])
    prev = _c2w([0.05, -0.01, 0.02, 0.01, 0.02, -0.004])
    prevprev = _c2w([0.03, -0.005, 0.01, 0.006, 0.012, -0.002])
    jR, jt = jtrk.motion_hypotheses_device(
        jnp.asarray(ref), jnp.asarray(prev), jnp.asarray(prevprev), jnp.bool_(have_motion),
        dt_ratio=jnp.float32(dt_ratio))
    tR, tt = ttrk.motion_hypotheses_device(_t(ref), _t(prev), _t(prevprev), have_motion,
                                           dt_ratio=dt_ratio)
    assert tR.shape == (32, 3, 3) and tt.shape == (32, 3)
    # products of 4x4s and a log/exp of the motion twist in f32
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=2e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-6)
    if not have_motion:
        np.testing.assert_array_equal(tR.numpy(), np.broadcast_to(np.eye(3), (32, 3, 3)))


def test_track_step_matches(scene):
    """The fused step from one state: pyramid of a uint8 frame, device-side
    hypotheses, scoring and the coarse-to-fine LM, in both packages."""
    sc = Scene(H, W, FX, n_blobs=16)
    R, t = se3_exp_np(np.array([0.03, -0.01, 0.02, 0.004, -0.006, 0.002]))
    img = np.clip(np.round(sc.render(R, t)), 0, 255).astype(np.uint8)
    ref = np.eye(4, dtype=np.float32)
    prev = _c2w([0.02, -0.007, 0.013, 0.003, -0.004, 0.0013])
    prevprev = _c2w([0.01, -0.0035, 0.0065, 0.0015, -0.002, 0.0007])
    K = np.array([FX, FX, W / 2 - 0.5, H / 2 - 0.5], np.float32)
    aff0 = np.zeros(2, np.float32)
    common = (np.float32(1.0), np.float32(1.0), np.zeros(2, np.float32))
    jo = _jit(jtrk.track_step, cfg=JConfig(**CFG_KW), n_levels=LEVELS)(
        scene["jtemplate"], jnp.asarray(img), jnp.asarray(K), jnp.asarray(ref),
        jnp.asarray(prev), jnp.asarray(prevprev), jnp.bool_(True), jnp.asarray(aff0),
        *(jnp.asarray(c) for c in common), dt_ratio=jnp.float32(1.5))
    to = ttrk.track_step(_port_template(scene), _t(img), _t(K), _t(ref), _t(prev), _t(prevprev),
                         True, _t(aff0), *(_t(c) for c in common), Config(**CFG_KW),
                         LEVELS, dt_ratio=1.5)
    for a, b in zip(to.pyr, jo.pyr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert bool(to.ok) == bool(jo.ok) and bool(to.ok)
    np.testing.assert_allclose(to.R.numpy(), np.asarray(jo.R), atol=1e-4)
    np.testing.assert_allclose(to.t.numpy(), np.asarray(jo.t), atol=1e-4)
    np.testing.assert_allclose(to.c2w.numpy(), np.asarray(jo.c2w), atol=1e-4)
    np.testing.assert_allclose(to.residuals.numpy(), np.asarray(jo.residuals), rtol=1e-3)
    # and the rendered motion is recovered (c2w of the worldToCam (R, t))
    np.testing.assert_allclose(to.t.numpy(), t, atol=2e-3)


@pytest.mark.parametrize("n_bins", [1, 7, 500])
def test_template_bin_sums_fixed_order(n_bins):
    """The template's per-pixel sums (build_template, utils/segsum.bin_sums)
    are the exactly rounded sums whatever the order of the entries, so the
    card gives the same bits on every run (a float index_add_ there does
    not)."""
    g = torch.Generator().manual_seed(n_bins)
    idx = torch.randint(0, n_bins, (300,), generator=g)
    vals = torch.randn(300, 2, generator=g) * 100.0
    out = bin_sums(idx, vals, n_bins)
    ref = torch.zeros(n_bins, 2, dtype=torch.float64).index_add_(0, idx, vals.double()).float()
    assert torch.equal(out, ref)
    perm = torch.randperm(300, generator=g)
    assert torch.equal(bin_sums(idx[perm], vals[perm], n_bins), out)
