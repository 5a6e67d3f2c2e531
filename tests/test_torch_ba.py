"""hslam_tpu_torch.ops.ba / models.optimizer against the JAX package, on the
windows of tests/test_ba.py converted with hslam_tpu_torch.convert, plus
the f64 dense-assembly and dense-elimination oracles of tests/test_ba.py and
tests/test_marg.py applied to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.config import CPARS
from hslam_tpu.models import optimizer as jopt
from hslam_tpu.models import window as JW
from hslam_tpu.ops import ba as jba
from hslam_tpu_torch.convert import from_numpy
from hslam_tpu_torch.models import optimizer as topt
from hslam_tpu_torch.ops import ba as tba
from test_ba import make_rendered_window, make_synthetic_window

torch.set_num_threads(1)


def port(tree):
    return from_numpy(jax.device_get(tree), "cpu")


def close(a, b, rel, name=""):
    """Compare to `rel` times the reference's magnitude (f32 sums taken in
    another order; state in solver units spans 1e-3 .. 1e14)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1.0), err_msg=name)


def _jax_ba_optimize(wnd, calib, cfg, n_iter, **kw):
    """The JAX package's ba_optimize inside one jit, as its kf_step runs it
    (compiled once, not op by op)."""
    return jax.jit(lambda w, c, **k: jopt.ba_optimize(w, c, cfg, n_iter, **k))(wnd, calib, **kw)


@pytest.fixture(scope="module")
def synth():
    wnd, calib, cfg = make_synthetic_window()
    return wnd, calib, cfg


def _grid(points, frames, F):
    return ((points.status == 1)[:, None] & frames.valid[None, :]
            & (points.host[:, None] != jnp.arange(F)[None, :]))


def test_adjoints_match(synth):
    wnd, _, _ = synth
    AHj, ATj = jba.compute_adjoints(wnd.frames)
    AHt, ATt = tba.compute_adjoints(port(wnd.frames))
    close(AHt, AHj, 1e-6, "AH")
    close(ATt, ATj, 1e-6, "AT")


@pytest.mark.parametrize("gather", ["packed", "window"])
def test_linearize_matches(synth, gather):
    wnd, calib, cfg = synth
    if gather == "window":
        lj = jba.linearize(wnd.frames, wnd.points, calib, cfg,
                           window_table=jba.build_window_table(wnd.frames.images))
    else:
        lj = jba.linearize(wnd.frames, wnd.points, calib, cfg)
    lt = tba.linearize(port(wnd.frames), port(wnd.points), port(calib), cfg,
                       window_gate=(gather == "window"))
    # the state machine is discrete: identical verdicts
    np.testing.assert_array_equal(lt.new_state.numpy(), np.asarray(lj.new_state))
    np.testing.assert_array_equal(lt.win_miss.numpy(), np.asarray(lj.win_miss))
    ok = np.asarray(lj.new_state) != JW.RES_OOB
    for name in ("Jpdc", "Jpdxi", "Jpdd", "center_u", "center_v", "center_idepth", "rel_bs"):
        close(getattr(lt, name), getattr(lj, name), 1e-5, name)
    # sampled intensities: a window sum and a bilinear lerp agree to ~1e-5
    for name in ("JIdx", "JabF", "resF"):
        close(getattr(lt, name).numpy()[ok], np.asarray(getattr(lj, name))[ok], 1e-4, name)
    close(lt.energy.numpy()[ok], np.asarray(lj.energy)[ok], 1e-4, "energy")


def _dense_oracle(lin, active, host, AH, AT, F):
    """f64 dense assembly of per-residual absolute Jacobians (the oracle of
    tests/test_ba.py::TestAccumulate), vectorized."""
    P = active.shape[0]
    D = CPARS + 8 * F
    C = np.concatenate([lin.JIdx, lin.JabF], -1).astype(np.float64)   # (P,F,8,4)
    B_rel = np.zeros((P, F, 4, 8))
    B_rel[:, :, 0:2, :6] = lin.Jpdxi
    B_rel[:, :, 2, 6] = 1.0
    B_rel[:, :, 3, 7] = 1.0
    J_rel = C @ B_rel                                                  # (P,F,8,8)
    J_abs = np.zeros((P, F, 8, D))
    J_abs[..., :CPARS] = C[..., :2] @ lin.Jpdc
    AHh = AH[host]                                                     # (P,F,8,8)
    ATh = AT[host]
    for f in range(F):
        for h in range(F):
            sel = host == h
            J_abs[sel, f, :, CPARS + 8 * h:CPARS + 8 * h + 8] += J_rel[sel, f] @ np.swapaxes(AHh[sel, f], -1, -2)
        J_abs[:, f, :, CPARS + 8 * f:CPARS + 8 * f + 8] += J_rel[:, f] @ np.swapaxes(ATh[:, f], -1, -2)
    J_d = (C[..., :2] @ lin.Jpdd[..., None])[..., 0]                   # (P,F,8)
    m = active.astype(np.float64)[..., None, None]
    Jm = J_abs * m
    r = lin.resF.astype(np.float64)
    H = np.einsum("pfki,pfkj->ij", Jm, J_abs)
    b = np.einsum("pfki,pfk->i", Jm, r)
    md = active.astype(np.float64)[..., None]
    Hdd = np.einsum("pfk,pfk->p", J_d * md, J_d)
    bd = np.einsum("pfk,pfk->p", J_d * md, r)
    g = np.einsum("pfki,pfk->pi", Jm, J_d)
    return H, b, Hdd, bd, g


def test_accumulate_matches_jax_and_f64_oracle(synth):
    wnd, calib, cfg = synth
    F = cfg.max_frames
    lj = jba.linearize(wnd.frames, wnd.points, calib, cfg)
    active = _grid(wnd.points, wnd.frames, F) & (lj.new_state == JW.RES_IN)
    AHj, ATj = jba.compute_adjoints(wnd.frames)
    sj = jba.accumulate(lj, active, wnd.points.host, AHj, ATj, F)
    lt = port(lj)
    st = tba.accumulate(lt, port(active), port(wnd.points.host), port(AHj), port(ATj), F)
    ln = jax.device_get(lj)
    H, b, Hdd, bd, g = _dense_oracle(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), ln),
        np.asarray(active), np.asarray(wnd.points.host),
        np.asarray(AHj, np.float64), np.asarray(ATj, np.float64), F)
    # tolerances of tests/test_ba.py (f32 accumulation vs f64 oracle)
    close(st.H, H, 2e-4, "H oracle")
    close(st.b, b, 2e-4, "b oracle")
    close(st.Hdd, Hdd, 1e-4, "Hdd oracle")
    close(st.bd, bd, 1e-4, "bd oracle")
    close(st.g, g, 1e-4, "g oracle")
    for name in ("H", "b", "Hdd", "bd", "g", "num_res"):
        close(getattr(st, name), getattr(sj, name), 2e-5, name)

    Hsc_j, bsc_j, HdiF_j = jba.schur_complement(sj, wnd.points.prior + 1.0, jnp.ones(
        cfg.max_points, bool))
    Hsc_t, bsc_t, HdiF_t = tba.schur_complement(st, port(wnd.points.prior) + 1.0,
                                                torch.ones(cfg.max_points, dtype=torch.bool))
    close(Hsc_t, Hsc_j, 1e-4, "H_sc")
    close(bsc_t, bsc_j, 1e-4, "b_sc")
    close(HdiF_t, HdiF_j, 1e-5, "HdiF")


def test_nullspaces_match(synth):
    wnd, _, cfg = synth
    Nj = jba.nullspaces(wnd.frames)
    Nt = tba.nullspaces(port(wnd.frames))
    close(Nt, Nj, 1e-6, "nullspaces")
    # the projector is sign-invariant even though SVD signs differ
    close(tba.nullspace_projector(Nt), jba.nullspace_projector(Nj), 1e-4, "projector")


def test_ba_optimize_matches():
    rng = np.random.default_rng(3)
    pert = np.zeros((4, 8), np.float32)
    pert[1:, :6] = rng.normal(0, 0.004, (3, 6))
    wnd, calib, cfg, _ = make_rendered_window(pert=jnp.asarray(pert))
    rj = _jax_ba_optimize(wnd, calib, cfg, 6)
    rt = topt.ba_optimize(port(wnd), port(calib), cfg, 6)
    np.testing.assert_array_equal(rt.window.points.res_state.numpy(),
                                  np.asarray(rj.window.points.res_state))
    np.testing.assert_array_equal(rt.newest_res_in.numpy(), np.asarray(rj.newest_res_in))
    # The f32 GN solve with priors of 1e10..1e14 is ill-conditioned along
    # the gauge: the JAX package against ITSELF, with the frame states
    # scaled by (1 + 1e-6), moves the solution by up to 4.5e-4 solver units
    # over these 6 iterations (measured). The state tolerance is 4x that;
    # the energy is held tighter.
    fj, ft = rj.window.frames, rt.window.frames
    np.testing.assert_allclose(ft.state.numpy(), np.asarray(fj.state), atol=2e-3)
    np.testing.assert_allclose(rt.window.points.idepth.numpy(),
                               np.asarray(rj.window.points.idepth), atol=2e-3)
    close(rt.rmse, rj.rmse, 1e-3, "rmse")
    close(ft.energy_th, fj.energy_th, 1e-3, "energy_th")


def _moved_frames(frames, seed):
    """The window's frames with every slot but 0 moved by ~0.003 solver
    units, the delta the frozen residuals must track."""
    st = np.asarray(frames.state).copy()
    st[1:] += 0.003 * np.random.default_rng(seed).normal(size=st[1:].shape)
    return frames._replace(state=jnp.asarray(st, jnp.float32))


@pytest.mark.parametrize("with_d_delta", [False, True], ids=["d0", "d_delta"])
def test_frozen_residuals_match(synth, with_d_delta):
    """Mode-1 machinery (ba.py:779-940 of the JAX package): residuals frozen
    at the window's state, then the resApprox, the frozen accumulation and
    the L-energy at a moved state, on the same inputs in both packages."""
    wnd, calib, cfg = synth
    F, P = cfg.max_frames, cfg.max_points
    lj = jba.linearize(wnd.frames, wnd.points, calib, cfg)
    active = _grid(wnd.points, wnd.frames, F) & (lj.new_state == JW.RES_IN)
    AH, AT = jba.compute_adjoints(wnd.frames)
    rng = np.random.default_rng(5)
    dd = (rng.normal(0, 0.01, P).astype(np.float32) if with_d_delta
          else np.zeros(P, np.float32))
    fj = jba.fix_linearization(lj, wnd.frames, calib, wnd.points.host, active, AH, AT,
                               jnp.asarray(dd))
    ft = tba.fix_linearization(port(lj), *port((wnd.frames, calib, wnd.points.host,
                                                active, AH, AT)), torch.from_numpy(dd))
    close(ft.res_toZero, fj.res_toZero, 1e-5, "res_toZero")

    frames2 = _moved_frames(wnd.frames, 7)
    AH2, AT2 = jba.compute_adjoints(frames2)
    args_j = (frames2, calib, wnd.points.host, AH2, AT2)
    args_t = port(args_j)
    dpj, cdj = jba.pair_deltas(frames2, calib, AH2, AT2)
    dpt, cdt = tba.pair_deltas(*port((frames2, calib, AH2, AT2)))
    close(dpt, dpj, 1e-5, "pair deltas")
    close(cdt, cdj, 1e-6, "calib delta")
    # f32 products of Jacobians and deltas summed in another order
    close(tba.frozen_resapprox(ft, *args_t, torch.from_numpy(dd)),
          jba.frozen_resapprox(fj, *args_j, jnp.asarray(dd)), 1e-5, "resApprox")
    sj = jba.accumulate_frozen(fj, *args_j, F, jnp.asarray(dd))
    st = tba.accumulate_frozen(ft, *args_t, F, torch.from_numpy(dd))
    for name in ("H", "b", "Hdd", "bd", "g", "num_res"):
        close(getattr(st, name), getattr(sj, name), 2e-5, name)
    prior = np.full(P, 3.0, np.float32)
    Ej = float(jba.calc_l_energy(fj, *args_j, jnp.asarray(prior), jnp.asarray(dd)))
    Et = float(tba.calc_l_energy(ft, *args_t, torch.from_numpy(prior), torch.from_numpy(dd)))
    # a sum of ~1e4 f32 terms of both signs: relative 1e-4 of the magnitude
    np.testing.assert_allclose(Et, Ej, rtol=1e-4, atol=1e-4 * max(abs(Ej), 1.0))


def test_m_energy_and_orthogonalize_match(synth):
    """calc_m_energy against its f64 formula, and orthogonalize (projection
    off the gauge nullspace) against the JAX package and an f64 check."""
    wnd, _, cfg = synth
    D = CPARS + 8 * cfg.max_frames
    rs = np.random.RandomState(3)
    A = rs.randn(D, D)
    HM = (A @ A.T).astype(np.float32)
    bM = rs.randn(D).astype(np.float32)
    delta = (0.01 * rs.randn(D)).astype(np.float32)
    Et = float(tba.calc_m_energy(torch.from_numpy(HM), torch.from_numpy(bM),
                                 torch.from_numpy(delta)))
    Ej = float(jba.calc_m_energy(jnp.asarray(HM), jnp.asarray(bM), jnp.asarray(delta)))
    d = delta.astype(np.float64)
    E_ref = d @ (2 * bM.astype(np.float64) + HM.astype(np.float64) @ d)
    np.testing.assert_allclose(Et, E_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(Et, Ej, rtol=1e-4, atol=1e-6)

    N = jba.nullspaces(wnd.frames)
    vec = rs.randn(D).astype(np.float32)
    ot = tba.orthogonalize(torch.from_numpy(vec), port(N)).numpy()
    close(ot, jba.orthogonalize(jnp.asarray(vec), N), 1e-4, "orthogonalize")
    # what is left has no component along any (normalized) gauge direction
    Nn = np.asarray(N, np.float64)
    Nn = Nn / np.maximum(np.linalg.norm(Nn, axis=0), 1e-12)
    assert np.abs(Nn.T @ ot.astype(np.float64)).max() < 1e-4 * np.abs(vec).max()


def test_ba_optimize_with_frozen_set_matches():
    """ba_optimize with half the residuals frozen (mode 1), against the JAX
    package from the same state; the frozen half must change the solution."""
    rng = np.random.default_rng(3)
    pert = np.zeros((4, 8), np.float32)
    pert[1:, :6] = rng.normal(0, 0.004, (3, 6))
    wnd, calib, cfg, _ = make_rendered_window(pert=jnp.asarray(pert))
    F = cfg.max_frames
    lj = jba.linearize(wnd.frames, wnd.points, calib, cfg)
    active = _grid(wnd.points, wnd.frames, F) & (lj.new_state == JW.RES_IN)
    freeze = active & (jnp.arange(cfg.max_points) % 2 == 0)[:, None]
    AH, AT = jba.compute_adjoints(wnd.frames)
    fj = jba.fix_linearization(lj, wnd.frames, calib, wnd.points.host, freeze, AH, AT)
    rj = _jax_ba_optimize(wnd, calib, cfg, 3, frozen=fj)
    rt = topt.ba_optimize(port(wnd), port(calib), cfg, 3, frozen=port(fj))
    plain = topt.ba_optimize(port(wnd), port(calib), cfg, 3)
    # the tolerances of test_ba_optimize_matches (the gauge's f32 conditioning)
    np.testing.assert_allclose(rt.window.frames.state.numpy(),
                               np.asarray(rj.window.frames.state), atol=2e-3)
    close(rt.rmse, rj.rmse, 1e-3, "rmse")
    assert (rt.window.frames.state - plain.window.frames.state).abs().max() > 1e-7


def test_marginalize_frame_f64_oracle(synth):
    """tests/test_marg.py::test_schur_elimination_matches_dense, on the port."""
    wnd, _, cfg = synth
    F = cfg.max_frames
    D = CPARS + 8 * F
    rs = np.random.RandomState(0)
    A = rs.randn(D, 2 * D)
    HM = (A @ A.T / (2 * D) + np.eye(D)).astype(np.float32) * 100.0
    bM = rs.randn(D).astype(np.float32) * 10.0
    twnd = port(wnd)._replace(HM=torch.from_numpy(HM), bM=torch.from_numpy(bM))
    slot = 2
    out = topt.marginalize_frame(twnd, slot, cfg)
    Hd, bd = HM.astype(np.float64), bM.astype(np.float64)
    prior = np.asarray(wnd.frames.prior[slot], np.float64)
    idx = np.arange(CPARS + 8 * slot, CPARS + 8 * slot + 8)
    Hd[idx, idx] += prior
    bd[idx] += prior * np.asarray(wnd.frames.state[slot], np.float64)
    keep = np.setdiff1d(np.arange(D), idx)
    Hinv = np.linalg.inv(Hd[np.ix_(idx, idx)])
    Hak = Hd[np.ix_(keep, idx)]
    H_new = Hd[np.ix_(keep, keep)] - Hak @ Hinv @ Hak.T
    b_new = bd[keep] - Hak @ (Hinv @ bd[idx])
    close(out.HM.numpy()[np.ix_(keep, keep)], H_new, 2e-3, "HM")
    close(out.bM.numpy()[keep], b_new, 2e-3, "bM")
    assert not bool(out.frames.valid[slot])
    assert float(out.HM[idx].abs().max()) == 0.0 and float(out.bM[idx].abs().max()) == 0.0
    jout = jopt.marginalize_frame(wnd._replace(HM=jnp.asarray(HM), bM=jnp.asarray(bM)),
                                  jnp.int32(slot), cfg)
    close(out.HM, jout.HM, 1e-4, "HM vs jax")


def test_marginalize_points_matches(synth):
    wnd, calib, cfg = synth
    P = cfg.max_points
    # fold half of the points (test_marg's point-marg setup, with a prior)
    wnd = wnd._replace(points=wnd.points._replace(prior=jnp.full(P, 50.0)))
    to_marg = np.arange(P) % 2 == 0
    to_drop = np.arange(P) % 7 == 1
    oj = jopt.marginalize_points(wnd, calib, jnp.asarray(to_marg), jnp.asarray(to_drop), cfg)
    ot = topt.marginalize_points(port(wnd), port(calib), torch.from_numpy(to_marg),
                                 torch.from_numpy(to_drop), cfg)
    np.testing.assert_array_equal(ot.points.status.numpy(), np.asarray(oj.points.status))
    assert float(np.abs(np.asarray(oj.HM)).max()) > 0
    close(ot.HM, oj.HM, 1e-4, "HM")
    close(ot.bM, oj.bM, 1e-4, "bM")


def _with_indirect(wnd, calib, cfg, seed=11, frac=0.6, noise=0.8):
    """tests/test_ba.py::TestIndirectFactors' observations: matched keypoints
    near the points' projections on a random subset of the residual grid."""
    P, F = cfg.max_points, cfg.max_frames
    lin0 = jba.linearize(wnd.frames, wnd.points, calib, cfg)
    key = jax.random.PRNGKey(seed)
    nz = jax.random.normal(key, (P, F, 2)) * noise
    pts = wnd.points._replace(
        ind_u=(lin0.center_u + nz[..., 0]).astype(jnp.float32),
        ind_v=(lin0.center_v + nz[..., 1]).astype(jnp.float32),
        ind_w=jnp.full((P, F), 25.0, jnp.float32),
        ind_valid=jax.random.uniform(jax.random.fold_in(key, 1), (P, F)) < frac)
    return wnd._replace(points=pts)


def test_linearize_indirect_matches(synth):
    wnd, calib, cfg = synth
    wnd = _with_indirect(wnd, calib, cfg)
    lj = jba.linearize(wnd.frames, wnd.points, calib, cfg)
    lt = tba.linearize(port(wnd.frames), port(wnd.points), port(calib), cfg)
    ok = np.asarray(lj.ind_ok)
    assert ok.sum() > 20
    np.testing.assert_array_equal(lt.ind_ok.numpy(), ok)
    close(lt.ind_res.numpy()[ok], np.asarray(lj.ind_res)[ok], 1e-5, "ind_res")
    close(lt.ind_wgt.numpy()[ok], np.asarray(lj.ind_wgt)[ok], 1e-6, "ind_wgt")
    close(lt.ind_energy.numpy()[ok], np.asarray(lj.ind_energy)[ok], 1e-5, "ind_energy")


def test_accumulate_indirect_matches(synth):
    """The BA's indirect reprojection terms with live observations: the port
    against the JAX package, and the indirect part alone against the f64
    dense assembly of tests/test_ba.py."""
    wnd, calib, cfg = synth
    wnd = _with_indirect(wnd, calib, cfg)
    F = cfg.max_frames
    lj = jba.linearize(wnd.frames, wnd.points, calib, cfg)
    grid = _grid(wnd.points, wnd.frames, F)
    active = grid & (lj.new_state == JW.RES_IN)
    ind_active = lj.ind_ok & grid
    assert int(ind_active.sum()) > 20
    AHj, ATj = jba.compute_adjoints(wnd.frames)
    sj = jba.accumulate(lj, active, wnd.points.host, AHj, ATj, F, ind_active=ind_active)
    args = (port(lj), port(active), port(wnd.points.host), port(AHj), port(ATj), F)
    st = tba.accumulate(*args, ind_active=port(ind_active))
    s0 = tba.accumulate(*args)
    for name in ("H", "b", "Hdd", "bd", "g", "num_res"):
        close(getattr(st, name), getattr(sj, name), 2e-5, name)
    # the indirect contribution alone, against f64 numpy (test_ba.py oracle)
    ln = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), jax.device_get(lj))
    ia, host = np.asarray(ind_active), np.asarray(wnd.points.host)
    AH, AT = np.asarray(AHj, np.float64), np.asarray(ATj, np.float64)
    P = ia.shape[0]
    D = CPARS + 8 * F
    H = np.zeros((D, D))
    b = np.zeros(D)
    Hdd = np.zeros(P)
    for p, f in zip(*np.nonzero(ia)):
        hs = host[p]
        J = np.zeros((2, D))
        J[:, :CPARS] = ln.Jpdc[p, f]
        J_rel = np.zeros((2, 8))
        J_rel[:, :6] = ln.Jpdxi[p, f]
        J[:, CPARS + 8 * hs:CPARS + 8 * hs + 8] += J_rel @ AH[hs, f].T
        J[:, CPARS + 8 * f:CPARS + 8 * f + 8] += J_rel @ AT[hs, f].T
        w, r = ln.ind_wgt[p, f], ln.ind_res[p, f]
        H += w * J.T @ J
        b += w * J.T @ r
        Hdd[p] += w * ln.Jpdd[p, f] @ ln.Jpdd[p, f]
    close(st.H.numpy().astype(np.float64) - s0.H.numpy(), H, 3e-4, "dH oracle")
    close(st.b.numpy().astype(np.float64) - s0.b.numpy(), b, 3e-4, "db oracle")
    close(st.Hdd.numpy().astype(np.float64) - s0.Hdd.numpy(), Hdd, 2e-4, "dHdd oracle")


def test_ba_optimize_indirect_matches():
    """ba_optimize with ground-truth keypoint observations on every residual
    (tests/test_ba.py::test_indirect_improves_pose_recovery's window), port
    against the JAX package; the indirect terms must move the solution."""
    rng = np.random.default_rng(3)
    pert = np.zeros((4, 8), np.float32)
    pert[1:, :6] = rng.normal(0, 0.004, (3, 6))
    wnd, calib, cfg, _ = make_rendered_window(pert=jnp.asarray(pert))
    P, F = cfg.max_points, cfg.max_frames
    lin_gt = jba.linearize(wnd.frames._replace(state=jnp.zeros((F, 8), jnp.float32)),
                           wnd.points, calib, cfg)
    wnd_ind = wnd._replace(points=wnd.points._replace(
        ind_u=lin_gt.center_u, ind_v=lin_gt.center_v,
        ind_w=jnp.full((P, F), 25.0, jnp.float32), ind_valid=jnp.ones((P, F), bool)))
    rj = _jax_ba_optimize(wnd_ind, calib, cfg, 6)
    rt = topt.ba_optimize(port(wnd_ind), port(calib), cfg, 6)
    plain = topt.ba_optimize(port(wnd), port(calib), cfg, 6)
    np.testing.assert_array_equal(rt.window.points.res_state.numpy(),
                                  np.asarray(rj.window.points.res_state))
    # the tolerances of test_ba_optimize_matches (the gauge's f32 conditioning)
    np.testing.assert_allclose(rt.window.frames.state.numpy(),
                               np.asarray(rj.window.frames.state), atol=2e-3)
    np.testing.assert_allclose(rt.window.points.idepth.numpy(),
                               np.asarray(rj.window.points.idepth), atol=2e-3)
    close(rt.rmse, rj.rmse, 1e-3, "rmse")
    assert (rt.window.frames.state - plain.window.frames.state).abs().max() > 1e-6
