"""Loop closure of hslam_tpu_torch against the JAX package on the CPU, the
same numpy inputs through both: the Sim3 half of utils/lie, ops/bow,
models/pose_graph (residuals, Jacobian, dense GN, matrix-free PCG) and the
LoopCloser on the drifted loop of tests/test_loop.py. The JAX solvers are
jitted as they stand; the rest runs inside one jax.jit where it matters."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.models import loop_closure as jlc
from hslam_tpu.models import pose_graph as jpg
from hslam_tpu.models.system import default_vocab_path as j_default_vocab_path
from hslam_tpu.ops import bow as jbow
from hslam_tpu.ops import orb as jorb
from hslam_tpu.ops import pnp as jpnp
from hslam_tpu.ops.pyramid import gaussian_blur7 as j_blur7
from hslam_tpu.utils import lie as jlie
from test_loop import _build_circle_sim3
from test_system import make_texture, render
from hslam_tpu_torch.convert import entries_from_numpy, entries_to_numpy, from_numpy, to_numpy
from hslam_tpu_torch.io.synthetic import Scene, se3_exp_np
from hslam_tpu_torch.models import loop_closure as tlc
from hslam_tpu_torch.models import pose_graph as tpg
from hslam_tpu_torch.models.system import default_vocab_path
from hslam_tpu_torch.ops import bow as tbow
from hslam_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _n(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- lie, Sim3
def _sim3_tangents():
    """Random tangents plus every combination of sigma and theta exactly
    zero, below the 1e-6 switch of the closed forms, and above it."""
    rng = np.random.default_rng(1)
    xi = [rng.normal(size=(32, 7)) * np.array([1, 1, 1, 0.6, 0.6, 0.6, 0.3])]
    axis = np.array([0.6, -0.48, 0.64])
    for theta in (0.0, 3e-7, 1e-2, 1.3):
        for sigma in (0.0, -4e-7, 2e-2, 0.4):
            xi.append(np.concatenate([[0.3, -0.2, 0.5], axis * theta, [sigma]])[None])
    return np.concatenate(xi).astype(np.float32)


# f32 evaluation of the same closed forms in two libraries
SIM3_ATOL = 1e-6


def test_sim3_exp_log_inverse_mul_match():
    xi = _sim3_tangents()
    js, jR, jt = _n(jax.jit(jlie.sim3_exp)(jnp.asarray(xi)))
    ts, tR, tt = tlie.sim3_exp(_t(xi))
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=SIM3_ATOL)
    np.testing.assert_allclose(tR.numpy(), jR, atol=SIM3_ATOL)
    np.testing.assert_allclose(tt.numpy(), jt, atol=SIM3_ATOL)
    # log, inverse and mul on the same (s, R, t) in both packages
    np.testing.assert_allclose(tlie.sim3_log(_t(js), _t(jR), _t(jt)).numpy(),
                               _n(jax.jit(jlie.sim3_log)(js, jR, jt)), atol=SIM3_ATOL)
    ji = _n(jlie.sim3_inverse(jnp.asarray(js), jnp.asarray(jR), jnp.asarray(jt)))
    ti = tlie.sim3_inverse(_t(js), _t(jR), _t(jt))
    for a, b in zip(ti, ji):
        np.testing.assert_allclose(a.numpy(), b, atol=SIM3_ATOL)
    jm = _n(jlie.sim3_mul(*(jnp.asarray(x) for x in (js, jR, jt)), *(jnp.asarray(x) for x in ji)))
    tm = tlie.sim3_mul(_t(js), _t(jR), _t(jt), *ti)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), b, atol=SIM3_ATOL)
    # exp(log(S)) = S and S * S^-1 = identity, in the port alone
    np.testing.assert_allclose(tlie.sim3_log(ts, tR, tt).numpy(), xi, atol=2e-5)
    np.testing.assert_allclose(tm[0].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(tm[2].numpy(), 0.0, atol=2e-6)


def test_sim3_exp_at_zero_is_identity_with_finite_forward_derivative():
    """Both small-angle arms are live at exactly zero; forward mode takes
    the tangent of the selected arm, so the derivative is finite there and
    equals the JAX package's."""
    z = torch.zeros(7)
    s, R, t = tlie.sim3_exp(z)
    assert float(s) == 1.0 and torch.equal(R, torch.eye(3)) and torch.equal(t, torch.zeros(3))
    eye = torch.eye(7)
    cols = [torch.func.jvp(lambda x: tlie.sim3_exp(x[None])[2][0], (z,), (eye[k],))[1]
            for k in range(7)]
    Jt = torch.stack(cols, 1).numpy()
    Jj = np.asarray(jax.jacfwd(lambda x: jlie.sim3_exp(x)[2])(jnp.zeros(7)))
    assert np.isfinite(Jt).all()
    np.testing.assert_allclose(Jt, Jj, atol=1e-6)


# --------------------------------------------------------------------- bow
def _descs(seed, n):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


def _vocab_pair(seed=0, n=500, k=6, levels=2, docs=None):
    train = _descs(seed, n)
    doc_ids = None if docs is None else np.repeat(np.arange(docs), n // docs)
    jv = jbow.train_vocabulary(train, k=k, levels=levels, iters=4, doc_ids=doc_ids)
    tv = tbow.train_vocabulary(train, k=k, levels=levels, iters=4, doc_ids=doc_ids,
                               device="cpu")
    return jv, tv


@pytest.mark.parametrize("docs", [None, 10], ids=["tf", "tf_idf"])
def test_train_vocabulary_identical(docs):
    """The numpy training with the same RandomState draws: the same tree
    and idf, bit for bit."""
    jv, tv = _vocab_pair(docs=docs)
    assert (tv.k, tv.levels, tv.n_words) == (jv.k, jv.levels, jv.n_words) == (6, 2, 36)
    np.testing.assert_array_equal(to_numpy(tv).centroids, np.asarray(jv.centroids))
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))
    if docs:
        assert float(tv.idf.max()) > 0.0


def _quantize_both(jv, tv, d, valid):
    jw = np.asarray(jax.jit(lambda a, b: jbow.quantize(jv, a, b))(jnp.asarray(d),
                                                                 jnp.asarray(valid)))
    tw = tbow.quantize(tv, _t(d.view(np.int32)), _t(valid)).numpy()
    return jw, tw


def test_quantize_vector_score_match_small_vocabulary():
    jv, tv = _vocab_pair(docs=10)
    d = _descs(7, 256)
    valid = np.random.default_rng(8).uniform(size=256) < 0.8
    jw, tw = _quantize_both(jv, tv, d, valid)
    # argmin ties (k children, 256-bit distances) break alike: words equal
    np.testing.assert_array_equal(tw, jw)
    assert (tw[~valid] == -1).all() and tw[valid].min() >= 0 and tw.max() < 36
    jvec = np.asarray(jbow.bow_vector(jnp.asarray(jw), jv.n_words, idf=jv.idf))
    tvec = tbow.bow_vector(_t(tw), tv.n_words, idf=tv.idf).numpy()
    np.testing.assert_allclose(tvec, jvec, atol=1e-6)
    np.testing.assert_allclose(tbow.bow_vector(_t(tw), 36).numpy(),
                               np.asarray(jbow.bow_vector(jnp.asarray(jw), 36)), atol=1e-6)
    # scores against a database of other documents
    db = np.stack([np.asarray(jbow.bow_vector(
        jnp.asarray(_quantize_both(jv, tv, _descs(20 + i, 64), np.ones(64, bool))[0]),
        36, idf=jv.idf)) for i in range(5)] + [jvec])
    js = np.asarray(jbow.l1_score(jnp.asarray(jvec), jnp.asarray(db)))
    ts = tbow.l1_score(_t(tvec), _t(db)).numpy()
    np.testing.assert_allclose(ts, js, atol=1e-6)
    assert abs(ts[-1] - 1.0) < 1e-5 and ts[:-1].max() < 0.95


def test_quantize_matches_on_the_shipped_vocabulary():
    """256 descriptors through the shipped 10^4-word tree (k=10, 4 levels)."""
    assert default_vocab_path() == j_default_vocab_path() is not None
    jv = jbow.load_vocabulary(default_vocab_path())
    tv = tbow.load_vocabulary(default_vocab_path(), device="cpu")
    assert (tv.k, tv.levels, tv.n_words) == (jv.k, jv.levels, jv.n_words) == (10, 4, 10_000)
    np.testing.assert_array_equal(to_numpy(tv).centroids, np.asarray(jv.centroids))
    # real descriptors of a rendered frame, and random ones
    img = Scene(96, 128, 80.0, n_blobs=16).render(np.eye(3), np.zeros(3))
    u, v, valid = jorb.grid_nms(jorb.fast_score(jnp.asarray(img), 8.0), 8, 128)
    real = np.asarray(jorb.rbrief(j_blur7(jnp.asarray(img)), u, v,
                                  jorb.ic_angle(jnp.asarray(img), u, v)))
    d = np.concatenate([real, _descs(3, 128)])
    val = np.concatenate([np.asarray(valid), np.ones(128, bool)])
    jw, tw = _quantize_both(jv, tv, d, val)
    np.testing.assert_array_equal(tw, jw)
    jvec = np.asarray(jbow.bow_vector(jnp.asarray(jw), jv.n_words, idf=jv.idf))
    tvec = tbow.bow_vector(_t(tw), tv.n_words, idf=tv.idf).numpy()
    np.testing.assert_allclose(tvec, jvec, atol=1e-6)


def test_vocabulary_save_load_round_trip_both_ways(tmp_path):
    jv, tv = _vocab_pair(docs=10)
    p = str(tmp_path / "port.npz")
    tbow.save_vocabulary(p, tv)
    back = tbow.load_vocabulary(p, device="cpu")
    assert torch.equal(back.centroids, tv.centroids) and torch.equal(back.idf, tv.idf)
    assert (back.k, back.levels, back.n_words) == (6, 2, 36)
    # what the port saved the JAX package loads, and the other way round
    jback = jbow.load_vocabulary(p)
    np.testing.assert_array_equal(np.asarray(jback.centroids), np.asarray(jv.centroids))
    pj = str(tmp_path / "jax.npz")
    jbow.save_vocabulary(pj, jv)
    assert torch.equal(tbow.load_vocabulary(pj, device="cpu").centroids, tv.centroids)
    # convert.py carries the structure across too
    conv = from_numpy(_n(jv), "cpu")
    assert torch.equal(conv.centroids, tv.centroids) and conv.n_words == 36


def test_empty_query_gives_a_zero_vector():
    """No valid descriptor: every word id is -1 and the vector is all zero
    (what LoopCloser.detect refuses to score)."""
    _, tv = _vocab_pair()
    w = tbow.quantize(tv, _t(_descs(1, 16).view(np.int32)), torch.zeros(16, dtype=torch.bool))
    assert (w == -1).all()
    vec = tbow.bow_vector(w, tv.n_words, idf=tv.idf)
    assert float(vec.abs().sum()) == 0.0 and torch.isfinite(vec).all()


# -------------------------------------------------------------- pose graph
def _graph_pair(N, **kw):
    jg = _build_circle_sim3(N, **kw)
    return jg, from_numpy(_n(jg), "cpu")


def _chi2(jg, s, R, t):
    g = jg._replace(s=jnp.asarray(s), R=jnp.asarray(R), t=jnp.asarray(t))
    r = jpg.residuals(g, jnp.zeros((jg.s.shape[0], 7)))
    return float(jnp.sum(r * r * jg.weight[:, None]))


def _sim3_gap(a, b):
    """max |log(A_i * B_i^-1)| over the nodes of two solutions."""
    a, b = ([jnp.asarray(np.asarray(x)) for x in s] for s in (a, b))
    return float(jnp.abs(jlie.sim3_log(*jlie.sim3_mul(*a, *jlie.sim3_inverse(*b)))).max())


def test_pose_graph_round_trip_and_make_graph():
    jg, tg = _graph_pair(30)
    assert tg.edge_i.dtype == torch.int64 and tg.valid.dtype == torch.bool
    back = to_numpy(tg)
    for a, b in zip(back, _n(jg)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    g = _n(jg)
    mg = tpg.make_graph(g.s, g.R, g.t, g.valid, g.edge_i, g.edge_j,
                        (g.meas_s, g.meas_R, g.meas_t), g.weight, device="cpu")
    for a, b in zip(mg, tg):
        assert torch.equal(a, b)


def test_residuals_match():
    jg, tg = _graph_pair(40)
    delta = (np.random.default_rng(2).normal(size=(40, 7)) * 0.05).astype(np.float32)
    for d in (np.zeros((40, 7), np.float32), delta):
        jr = np.asarray(jax.jit(jpg.residuals)(jg, jnp.asarray(d)))
        np.testing.assert_allclose(tpg.residuals(tg, _t(d)).numpy(), jr, atol=1e-5)


def test_jacobian_at_zero_matches_jacfwd():
    """The (7E, 7N) Jacobian assembled from the per-edge blocks against
    jax.jacfwd of the whole residual vector, at delta = 0, where every
    small-angle branch of sim3_exp is live."""
    N = 30
    jg, tg = _graph_pair(N)

    def res_flat(delta):
        return (jpg.residuals(jg, delta) * jnp.sqrt(jg.weight)[:, None]).reshape(-1)

    Jj = np.asarray(jax.jit(jax.jacfwd(res_flat))(jnp.zeros((N, 7)))).reshape(-1, N * 7)
    Jt = tpg.dense_jacobian(tg).numpy()
    assert Jt.shape == Jj.shape == (7 * N, 7 * N) and np.isfinite(Jt).all()
    np.testing.assert_allclose(Jt, Jj, atol=1e-4)


def test_dense_gn_matches_jax():
    """lam = 1e-6 leaves the solve ill-conditioned by design, so the two f32
    solvers are held by their results: 5e-3 on the per-node Sim3 log (the
    bound tests/test_loop.py puts between its own two solvers) and the same
    chi^2 gate."""
    jg, tg = _graph_pair(40)
    c0 = _chi2(jg, jg.s, jg.R, jg.t)
    jsol = _n(jpg.optimize_pose_graph(jg, n_iters=10))
    tsol = [x.numpy() for x in tpg.optimize_pose_graph(tg, n_iters=10)]
    assert _chi2(jg, *jsol) < 1e-2 * c0 and _chi2(jg, *tsol) < 1e-2 * c0
    assert _sim3_gap(tsol, jsol) < 5e-3


def test_pcg_matches_dense_and_jax_pcg():
    jg, tg = _graph_pair(40)
    c0 = _chi2(jg, jg.s, jg.R, jg.t)
    dense = [x.numpy() for x in tpg.optimize_pose_graph(tg, n_iters=10)]
    stats = {}
    pcg = [x.numpy() for x in tpg.optimize_pose_graph_pcg(tg, n_iters=10, cg_iters=600,
                                                          stats=stats)]
    assert _chi2(jg, *pcg) < 1e-2 * c0
    assert _sim3_gap(pcg, dense) < 5e-3
    jp = _n(jpg.optimize_pose_graph_pcg(jg, n_iters=10, cg_iters=600))
    assert _sim3_gap(pcg, jp) < 5e-3
    # the stopping rule is tested once per CG iteration and once more when
    # it stops a solve: one host sync each
    assert 0 < stats["cg_iterations"] <= stats["host_syncs"] <= stats["cg_iterations"] + 10


def test_pcg_fix_scale_pins_sigma():
    jg, tg = _graph_pair(30, scale_drift=1.0)
    s, R, t = (x.numpy() for x in tpg.optimize_pose_graph_pcg(tg, n_iters=8, cg_iters=400,
                                                               fix_scale=True))
    np.testing.assert_allclose(s, 1.0, atol=1e-4)
    assert _chi2(jg, s, R, t) < 0.1 * _chi2(jg, jg.s, jg.R, jg.t)
    sd = tpg.optimize_pose_graph(tg, n_iters=8, fix_scale=True)[0].numpy()
    np.testing.assert_allclose(sd, 1.0, atol=1e-4)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pad_graph_changes_no_result(solver):
    """Invalid identity nodes and weight-0 self-loops on node 0 add nothing
    to b, H or the preconditioner."""
    _, tg = _graph_pair(30)
    padded = tpg.pad_graph(tg, 32, 64)
    assert padded.s.shape[0] == 32 and padded.edge_i.shape[0] == 64
    assert tpg.pad_graph(tg, 30, 30) is tg
    with pytest.raises(ValueError):
        tpg.pad_graph(tg, 16, 64)
    run = {"dense": lambda g: tpg.optimize_pose_graph(g, n_iters=6),
           "pcg": lambda g: tpg.optimize_pose_graph_pcg(g, n_iters=6, cg_iters=300)}[solver]
    a = [x.numpy() for x in run(tg)]
    b = [x.numpy()[:30] for x in run(padded)]
    assert _sim3_gap(a, b) < 1e-4
    assert [tpg.bucket_size(n) for n in (1, 32, 33, 512, 513)] == [32, 32, 64, 512, 1024]


def test_wrong_match_edge_stays_finite():
    """A loop edge that contradicts the chain by metres: the per-node trust
    region keeps every iterate finite in both solvers."""
    _, tg = _graph_pair(30)
    bad_t = tg.meas_t.clone()
    bad_t[-1] = torch.tensor([40.0, -25.0, 30.0])
    bad = tg._replace(meas_t=bad_t, meas_s=torch.cat([tg.meas_s[:-1], torch.tensor([5.0])]))
    for sol in (tpg.optimize_pose_graph(bad, n_iters=8),
                tpg.optimize_pose_graph_pcg(bad, n_iters=8, cg_iters=200)):
        assert all(torch.isfinite(x).all() for x in sol)


@pytest.mark.slow
def test_pcg_10k_nodes():
    """tests/test_loop.py's 10,000-keyframe graph on the port (the card
    runs it in chip_smoke.py)."""
    jg, tg = _graph_pair(10_000, scale_drift=1.00005, noise=0.002)
    c0 = _chi2(jg, jg.s, jg.R, jg.t)
    sol = [x.numpy() for x in tpg.optimize_pose_graph_pcg(tg, n_iters=5, cg_iters=1000)]
    assert _chi2(jg, *sol) < 1e-3 * c0 and np.isfinite(sol[2]).all()


# -------------------------------------------------------------- LoopCloser
H, W, FX = 96, 128, 80.0
CX, CY = W / 2 - 0.5, H / 2 - 0.5
K = np.array([[FX, 0, CX], [0, FX, CY], [0, 0, 1.0]])
N_KF, DEPTH = 20, 2.0


def _T(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


@pytest.fixture(scope="module")
def loop_case():
    """tests/test_loop.py's drifted loop (out along +x and back, the last
    pose equal to the first, a constant bias per step in the estimates) on
    its texture, features from the JAX package, a k=6, 2-level vocabulary
    from the first six frames. Both closers hold the same database."""
    I0 = make_texture()
    gt = [_T(*se3_exp_np(np.array([0.35 * np.sin(a), 0.12 * (1 - np.cos(a)), 0, 0, 0, 0])))
          for a in 2 * np.pi * np.arange(N_KF) / N_KF]
    drift = _T(*se3_exp_np(np.array([0.01, -0.006, 0.004, 0.002, 0.003, -0.002])))
    est = [np.eye(4)]
    for i in range(1, N_KF):
        est.append(drift @ gt[i] @ np.linalg.inv(gt[i - 1]) @ est[-1])

    @jax.jit
    def features(img):
        u, v, valid = jorb.grid_nms(jorb.fast_score(img, 8.0), 8, 256)
        return u, v, valid, jorb.rbrief(j_blur7(img), u, v, jorb.ic_angle(img, u, v))

    feats = [_n(features(jnp.asarray(render(I0, jnp.asarray(T[:3, :3], jnp.float32),
                                            jnp.asarray(T[:3, 3], jnp.float32)))))
             for T in gt]
    pool = np.concatenate([d[val] for _, _, val, d in feats[:6]])
    jv = jbow.train_vocabulary(pool, k=6, levels=2, iters=4)
    jcl = jlc.LoopCloser(jv, min_gap=10, min_inliers=20)
    tcl = tlc.LoopCloser(from_numpy(_n(jv), "cpu"), min_gap=10, min_inliers=20)
    for i, (u, v, valid, d) in enumerate(feats):
        # analytic keypoint depths: rays hitting the plane z_world = DEPTH
        c2w = np.linalg.inv(gt[i])
        dirs = np.stack([(u - CX) / FX, (v - CY) / FX, np.ones_like(u)], -1)
        zc = (DEPTH - c2w[2, 3]) / np.maximum(dirs @ c2w[2, :3], 1e-6)
        kp_idepth = (1.0 / np.maximum(zc, 1e-3)).astype(np.float32)
        # entries store camToWorld of the DRIFTED estimate
        args = (i, i, None, u, v, valid, np.linalg.inv(est[i]))
        jcl.add_keyframe(*args[:2], jnp.asarray(d), *args[3:], kp_idepth=kp_idepth,
                         kp_depth_ok=valid)
        tcl.add_keyframe(*args[:2], _t(d.view(np.int32)), *args[3:], kp_idepth=kp_idepth,
                         kp_depth_ok=valid)
    return dict(gt=gt, jcl=jcl, tcl=tcl)


def _gap(closer, gt):
    """|log| of the estimated last->first relative pose against the truth."""
    rel_est = np.linalg.inv(closer.entries[N_KF - 1].cam_to_world) @ closer.entries[0].cam_to_world
    err = rel_est @ np.linalg.inv(gt[N_KF - 1] @ np.linalg.inv(gt[0]))
    return float(np.linalg.norm(np.asarray(jlie.se3_log(jnp.asarray(err[:3, :3]),
                                                        jnp.asarray(err[:3, 3])))))


def test_loop_database_matches(loop_case):
    """add_keyframe through both packages: the same BoW vectors, and the
    database crosses convert.py both ways."""
    jcl, tcl = loop_case["jcl"], loop_case["tcl"]
    for je, te in zip(jcl.entries, tcl.entries):
        np.testing.assert_allclose(te.bow, je.bow, atol=1e-6)
        np.testing.assert_array_equal(te.desc.view(np.uint32), je.desc)
    conv = entries_from_numpy(jcl.entries)
    assert conv[3].desc.dtype == np.int32 and conv[3].cam_to_world is not jcl.entries[3].cam_to_world
    np.testing.assert_array_equal(conv[3].desc, tcl.entries[3].desc)
    back = jlc.KeyframeEntry(**entries_to_numpy(tcl.entries)[3])
    np.testing.assert_array_equal(back.desc, jcl.entries[3].desc)
    np.testing.assert_array_equal(back.kp_idepth, jcl.entries[3].kp_idepth)


def test_detect_and_correct_drifted_loop_matches_jax(loop_case, monkeypatch):
    """The revisit through both packages with the JAX package's RANSAC draws
    (C3): the same match, the same loop edge, the same corrected poses."""
    gt = loop_case["gt"]
    jcl, tcl = copy.deepcopy(loop_case["jcl"]), copy.deepcopy(loop_case["tcl"])
    drawn = []
    real = jpnp.solve_pnp_jit

    def recording(X, x_px, valid, Kd, key, **kw):
        p = jnp.asarray(valid, jnp.float32)
        drawn.append(np.asarray(jax.random.choice(
            key, X.shape[0], shape=(64, 6), p=p / jnp.maximum(p.sum(), 1.0))))
        return real(X, x_px, valid, Kd, key, **kw)

    monkeypatch.setattr(jpnp, "solve_pnp_jit", recording)
    jloop = jcl.detect(N_KF - 1, K)
    assert jloop is not None and len(drawn) == 2
    tloop = tcl.detect(N_KF - 1, K, samples=tuple(drawn))
    assert tloop is not None
    assert tloop.match_kf == jloop.match_kf and abs(tloop.match_kf - (N_KF - 1)) >= 10
    assert tloop.query_kf == jloop.query_kf == N_KF - 1
    assert abs(tloop.n_inliers - jloop.n_inliers) <= 2
    np.testing.assert_allclose(tloop.rel_R, jloop.rel_R, atol=1e-3)
    np.testing.assert_allclose(tloop.rel_t, jloop.rel_t, atol=1e-3)

    g0 = _gap(tcl, gt)
    jout = jcl.correct(jloop, fix_scale=True)
    tout = tcl.correct(tloop, fix_scale=True)
    assert len(tout) == len(jout) == N_KF
    for (jsid, jT), (tsid, tT) in zip(jout, tout):
        assert jsid == tsid
        np.testing.assert_allclose(tT, jT, atol=5e-3)
    assert _gap(tcl, gt) < 0.6 * g0, (g0, _gap(tcl, gt))
    # the port's own draws (a torch.Generator seeded with the same integers)
    own = copy.deepcopy(loop_case["tcl"])
    oloop = own.detect(N_KF - 1, K)
    assert oloop is not None and oloop.match_kf == jloop.match_kf
    np.testing.assert_allclose(oloop.rel_t, jloop.rel_t, atol=2e-2)


def test_detect_gates(loop_case):
    """The refusals of detect that need no PnP, and the significance gate."""
    base = loop_case["tcl"]
    # an empty query never scores
    c = copy.deepcopy(base)
    c.entries[-1].bow = np.zeros_like(c.entries[-1].bow)
    assert c.detect(N_KF - 1, K) is None
    # every old keyframe excluded by the connectivity map, or inside min_gap
    c = copy.deepcopy(base)
    assert c.detect(N_KF - 1, K, exclude_kfs=set(range(N_KF))) is None
    c.min_gap = N_KF
    assert c.detect(N_KF - 1, K) is None
    # consistency: the first agreement only starts the streak, a second fires
    c = copy.deepcopy(base)
    c.consistency_th = 2
    assert c.detect(N_KF - 1, K) is None and c._consist_count == 1
    assert c.detect(N_KF - 1, K) is not None and c._consist_count == 0
    # candidate without depths: no metric edge
    c = copy.deepcopy(base)
    for e in c.entries:
        e.kp_idepth = None
    assert c.detect(N_KF - 1, K) is None
    # significance: a verified loop below min_loop_error_rel run scales is
    # counted, not returned
    c = copy.deepcopy(base)
    c.min_loop_error_rel = 50.0
    assert c.detect(N_KF - 1, K) is None and c.n_verified_insignificant == 1
    c.min_loop_error_rel = 1e-3
    assert c.detect(N_KF - 1, K) is not None and c.n_verified_insignificant == 1


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A port Mesh over a world of one (Gloo, file rendezvous), torn down
    with the module: the default group is global state in a worker."""
    from hslam_tpu_torch.parallel import distributed as D
    D.initialize(f"file://{tmp_path_factory.mktemp('rdv')}/rdv", 1, 0, "gloo")
    yield D.global_mesh("edges")
    torch.distributed.destroy_process_group()


def test_correct_rejects_a_diverging_edge_and_the_sharded_branch(loop_case, monkeypatch, mesh1):
    c = copy.deepcopy(loop_case["tcl"])
    before = [e.cam_to_world.copy() for e in c.entries]
    loop = tlc.LoopResult(N_KF - 1, 0, np.eye(3), np.zeros(3), 1.0, 60)
    # a relaxation that ends with a larger chi^2 than it started from (what
    # a wrong-match edge can do to the solve) is not applied
    real = tpg.optimize_pose_graph

    def diverged(pg, **kw):
        s, R, t = real(pg, **kw)
        return s, R, t + 0.5 * torch.arange(t.shape[0])[:, None] ** 2
    monkeypatch.setattr(tpg, "optimize_pose_graph", diverged)
    assert c.correct(loop, fix_scale=True) == []
    monkeypatch.setattr(tpg, "optimize_pose_graph", real)
    # a non-finite edge
    nan = tlc.LoopResult(N_KF - 1, 0, np.eye(3), np.array([np.nan, 0, 0]), 1.0, 40)
    assert c.correct(nan) == []
    for e, T0 in zip(c.entries, before):
        np.testing.assert_array_equal(e.cam_to_world, T0)
    # beyond dense_max_nodes the matrix-free solver runs; with a mesh the
    # edge-sharded one, which on a world of one gives the same bits
    c.dense_max_nodes = 4
    e = copy.deepcopy(c)
    d = copy.deepcopy(loop_case["tcl"])
    out_pcg = c.correct(loop, fix_scale=True)
    out_dense = d.correct(loop, fix_scale=True)
    assert len(out_pcg) == N_KF
    for (_, a), (_, b) in zip(out_pcg, out_dense):
        np.testing.assert_allclose(a, b, atol=2e-3)
    e.dist_mesh = mesh1
    calls = mesh1.n_collectives
    out_sharded = e.correct(loop, fix_scale=True)
    assert mesh1.n_collectives > calls
    assert len(out_sharded) == N_KF
    for (ia, a), (ib, b) in zip(out_sharded, out_pcg):
        assert ia == ib
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- the loop sequence, full size
# The JAX package (XLA:CPU) over the 640x480 loop sequence that
# chip_smoke.py drives through the port on the card: the 60-frame arc, then
# io/synthetic.make_loop_frames (the arc again under flicker, the flight
# back, the revisit), default hybrid Config with bench.py's capacities,
# sequential entry, loop closure on the shipped vocabulary. chip_smoke.py
# hard-codes these as its bars.
JAX_LOOP_SEQUENCE = dict(frames=326, keyframes=29, valid=326, ate=0.019407264043568895,
                         loops_closed=0, verified_insignificant=16)


@pytest.mark.slow
def test_loop_sequence_jax_reference():
    from hslam_tpu.config import Config as JConfig
    from hslam_tpu.models.system import SLAMSystem as JSLAM
    from hslam_tpu_torch.io.synthetic import make_loop_frames, make_sequence
    from hslam_tpu_torch.io.trajectory import ate_rmse
    Hh, Ww, fx = 480, 640, 320.0
    scene = Scene(Hh, Ww, fx)
    frames, centres = make_sequence(scene, 60)
    lf, lc, ls = make_loop_frames(scene, 60)
    frames, centres = frames + lf, np.concatenate([centres, lc])
    stamps = [0.05 * i for i in range(60)] + ls
    cfg = JConfig(max_frames=8, max_points=2048, max_immature=2048, pyr_levels=6)
    slam = JSLAM(fx, fx, Ww / 2 - 0.5, Hh / 2 - 0.5, Ww, Hh, cfg)
    for f, ts in zip(frames, stamps):
        slam.process_frame(f, ts)
    valid = [s.id for s in slam.shells if s.pose_valid]
    ate = ate_rmse(centres[valid], np.array([slam.shells[i].cam_to_world[:3, 3] for i in valid]))
    got = dict(frames=len(frames), keyframes=slam.next_kf_id, valid=len(valid), ate=float(ate),
               loops_closed=slam.n_loops_closed,
               verified_insignificant=slam.loop_closer.n_verified_insignificant)
    print("JAX loop sequence:", got, "lost", slam.is_lost, "relocs", slam.n_relocs)
    assert not slam.is_lost
    ref = JAX_LOOP_SEQUENCE
    assert got["frames"] == ref["frames"] and got["keyframes"] == ref["keyframes"]
    assert got["valid"] == ref["valid"] and abs(got["ate"] - ref["ate"]) <= 0.25 * ref["ate"]
    assert got["loops_closed"] == ref["loops_closed"]
    assert got["verified_insignificant"] == ref["verified_insignificant"]
