"""hslam_tpu_torch.parallel: the point-sharded window BA and marginalization,
the edge-sharded Sim3 PCG and the keyframe-block-sharded global BA, held
(a) to the JAX package's single-device functions, each under one jax.jit,
(b) on a world of one to the port's unsharded functions bit for bit, and
(c) on two ranks over Gloo (one spawn) to the unsharded functions within
tests/test_dist.py's and tests/test_global_ba.py's tolerances; plus
`distributed.initialize`. The JAX package's shard_maps are not compiled
here: tests/test_dist.py holds them to its single-device functions.

JAX is imported inside the fixtures, not at the top: the two-rank case
spawns interpreters that import this module by name, and they need torch
only."""
import dataclasses
import socket
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hslam_tpu_torch.config import CPARS, Config
from hslam_tpu_torch.convert import from_numpy, to_numpy
from hslam_tpu_torch.models import optimizer as topt
from hslam_tpu_torch.models import pose_graph as tpg
from hslam_tpu_torch.models import window as TW
from hslam_tpu_torch.ops import ba as tba
from hslam_tpu_torch.parallel import distributed as D
from hslam_tpu_torch.parallel import global_ba as tgba
from hslam_tpu_torch.parallel.dist_ba import (sharded_ba_optimize, sharded_ba_step,
                                              sharded_marginalize_points)
from hslam_tpu_torch.parallel.dist_pose_graph import (pad_edges,
                                                      sharded_optimize_pose_graph_pcg)

torch.set_num_threads(1)


# ------------------------------------------------------------ initialize
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def test_initialize_is_a_noop_without_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    D.initialize()
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        D.initialize("127.0.0.1:1", num_processes=2)       # no rank


def test_initialize_reads_torchruns_env(monkeypatch):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    for k, v in zip(_ENV, ("127.0.0.1", str(port), "1", "0")):
        monkeypatch.setenv(k, v)
    D.initialize(backend="gloo")
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        D.initialize(backend="gloo")                       # a group exists: no-op
        mesh = D.global_mesh("points")
        assert (mesh.size, mesh.rank, mesh.axis_names) == (1, 0, ("points",))
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(D.all_gather(x, mesh), x)
        assert D.psum(torch.tensor([True, False, True]), mesh).dtype == torch.int64
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def jx():
    """The JAX side: the package's modules and the fixtures of its tests."""
    import jax
    import jax.numpy as jnp

    import test_ba
    import test_global_ba
    import test_loop
    from hslam_tpu.models import optimizer as jopt
    from hslam_tpu.models import pose_graph as jpg
    from hslam_tpu.parallel import dist_pose_graph as jdpg
    from hslam_tpu.parallel import global_ba as jgba
    return SimpleNamespace(jax=jax, jnp=jnp, test_ba=test_ba, test_loop=test_loop,
                           test_global_ba=test_global_ba, jopt=jopt, jpg=jpg,
                           jdpg=jdpg, jgba=jgba)


def _port(jx, tree):
    return from_numpy(jx.jax.device_get(tree), "cpu")


def _port_cfg(jcfg):
    return Config(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def inputs(jx):
    """Port structures (CPU) of the JAX tests' fixtures: the window of
    tests/test_ba.py, conditioned with frame priors of 1e8 for the optimize
    (tests/test_dist.py), the marginalization flags of tests/test_dist.py,
    the 61-node circle of tests/test_loop.py and the partitioned problem of
    tests/test_global_ba.py::test_sharded_matches_host (N=16, ppk=5)."""
    wnd, calib, jcfg = jx.test_ba.make_synthetic_window()
    cond = wnd._replace(frames=wnd.frames._replace(
        prior=jx.jnp.full_like(wnd.frames.prior, 1e8)))
    P = jcfg.max_points
    to_marg = np.arange(P) % 5 == 0
    to_drop = (np.arange(P) % 7 == 3) & ~to_marg
    pg = jx.test_loop._build_circle_sim3(61, scale_drift=1.002, noise=0.005)
    _, noisy = jx.test_global_ba._make_problem(N=16, ppk=5, seed=4)
    return dict(
        synth=(_port(jx, wnd), _port(jx, calib), _port_cfg(jcfg)),
        cond=(_port(jx, cond), _port(jx, calib), _port_cfg(jcfg)),
        marg=(torch.from_numpy(to_marg), torch.from_numpy(to_drop)),
        pg=_port(jx, pg),
        gba=tgba.partition_problem(_port(jx, noisy), 2),
        K=jx.test_global_ba.K)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A port Mesh over a world of one (Gloo, file rendezvous), torn down
    with the module: the default group is global state in a worker."""
    D.initialize(f"file://{tmp_path_factory.mktemp('rdv')}/rdv", 1, 0, "gloo")
    yield D.global_mesh("points")
    dist.destroy_process_group()


# ------------------------------------------------------- against the JAX package
@pytest.mark.parametrize("multiple", [1, 3, 8])
def test_pad_edges_matches_jax(jx, multiple):
    pg = jx.test_loop._build_circle_sim3(61, scale_drift=1.002, noise=0.005)
    want = to_numpy(_port(jx, jx.jdpg.pad_edges(pg, multiple)))
    got = to_numpy(pad_edges(_port(jx, pg), multiple))
    assert got.edge_i.shape[0] % multiple == 0
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_partition_problem_matches_jax(jx, n_shards):
    _, noisy = jx.test_global_ba._make_problem(N=9, ppk=4, seed=5)
    want = jx.jax.device_get(jx.jgba.partition_problem(noisy, n_shards))
    got = to_numpy(tgba.partition_problem(_port(jx, noisy), n_shards))
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_build_problem_matches_jax(jx):
    """build_problem_from_trajectory draws as the JAX package's does: the
    same problem from the same numpy generator."""
    g = jx.test_global_ba
    Rs, ts = g._traj(12)

    def depth_fn(u, v, i):
        return g._plane_depth(Rs[i], ts[i])(u, v, i)

    kw = dict(points_per_kf=8, obs_radius=4, width=g.W_, height=g.H_, depth_fn=depth_fn,
              pix_noise=0.1)
    want = jx.jax.device_get(jx.jgba.build_problem_from_trajectory(
        Rs, ts, g.K, rng=np.random.default_rng(1), **kw))
    got = to_numpy(tgba.build_problem_from_trajectory(
        Rs, ts, g.K, rng=np.random.default_rng(1), device="cpu", **kw))
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.fixture(scope="module")
def gba_case(jx):
    """tests/test_global_ba.py::test_converges_to_ground_truth's problem and
    the JAX package's relaxation of it (6 GN steps, 80 CG iterations)."""
    g = jx.test_global_ba
    gt, noisy = g._make_problem(N=12, ppk=8, radius=4, seed=1)
    K = jx.jnp.asarray(g.K, jx.jnp.float32)
    step = jx.jax.jit(lambda p: jx.jgba.gn_step(p, K, cg_iters=80))(noisy)
    full = jx.jax.jit(lambda p: jx.jgba.global_ba(p, K, n_iters=6, cg_iters=80))(noisy)
    return gt, noisy, jx.jax.device_get(step), jx.jax.device_get(full)


def test_gn_step_matches_jax(jx, gba_case):
    _, noisy, (jp, jchi), _ = gba_case
    K = torch.as_tensor(jx.test_global_ba.K, dtype=torch.float32)
    tp, tchi = tgba.gn_step(_port(jx, noisy), K, cg_iters=80)
    np.testing.assert_allclose(float(tchi), float(jchi), rtol=1e-5)
    np.testing.assert_allclose(tp.R.numpy(), jp.R, atol=1e-5)
    np.testing.assert_allclose(tp.t.numpy(), jp.t, atol=1e-4)
    np.testing.assert_allclose(tp.rho.numpy(), jp.rho, atol=1e-4)


def test_global_ba_matches_jax(jx, gba_case):
    """Within 2e-3 (test_sharded_matches_host's tolerances) of the JAX
    package's relaxation, and passing test_converges_to_ground_truth's bars."""
    gt, noisy, _, (jp, jchis) = gba_case
    tp, tchis = tgba.global_ba(_port(jx, noisy), jx.test_global_ba.K, n_iters=6, cg_iters=80)
    np.testing.assert_allclose(tchis.numpy(), jchis, rtol=2e-3)
    np.testing.assert_allclose(tp.t.numpy(), jp.t, atol=2e-3)
    np.testing.assert_allclose(tp.R.numpy(), jp.R, atol=2e-3)
    np.testing.assert_allclose(tp.rho.numpy(), jp.rho, atol=5e-3)
    err0 = jx.test_global_ba._pose_err(noisy, gt)
    err1 = jx.test_global_ba._pose_err(to_numpy(tp), gt)
    assert tchis[-1] < 0.05 * tchis[0] and err1 < 0.25 * err0


def test_sharded_ba_optimize_matches_jax(jx, mesh1):
    """tests/test_torch_ba.py::test_ba_optimize_matches with the port's
    side point-sharded over a world of one."""
    rng = np.random.default_rng(3)
    pert = np.zeros((4, 8), np.float32)
    pert[1:, :6] = rng.normal(0, 0.004, (3, 6))
    wnd, calib, cfg, _ = jx.test_ba.make_rendered_window(pert=jx.jnp.asarray(pert))
    rj = jx.jax.jit(lambda w, c: jx.jopt.ba_optimize(w, c, cfg, 6))(wnd, calib)
    rt = sharded_ba_optimize(mesh1, _port(jx, wnd), _port(jx, calib), cfg, 6)
    np.testing.assert_array_equal(rt.window.points.res_state.numpy(),
                                  np.asarray(rj.window.points.res_state))
    np.testing.assert_array_equal(rt.newest_res_in.numpy(), np.asarray(rj.newest_res_in))
    # the tolerances of test_ba_optimize_matches (the f32 solve along the gauge)
    np.testing.assert_allclose(rt.window.frames.state.numpy(),
                               np.asarray(rj.window.frames.state), atol=2e-3)
    np.testing.assert_allclose(rt.window.points.idepth.numpy(),
                               np.asarray(rj.window.points.idepth), atol=2e-3)
    np.testing.assert_allclose(float(rt.rmse), float(rj.rmse), rtol=1e-3)


def test_sharded_pcg_matches_jax(jx, mesh1):
    """The edge-sharded PCG over a world of one against the JAX package's
    single-device PCG on tests/test_dist.py's circle, to that test's
    tolerances."""
    pg = jx.test_loop._build_circle_sim3(61, scale_drift=1.002, noise=0.005)
    s1, R1, t1 = jx.jax.device_get(jx.jpg.optimize_pose_graph_pcg(pg, n_iters=8, cg_iters=400))
    s, R, t = sharded_optimize_pose_graph_pcg(mesh1, _port(jx, pg), n_iters=8, cg_iters=400)
    np.testing.assert_allclose(s.numpy(), s1, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(t.numpy(), t1, rtol=0, atol=5e-3)
    chi_1 = jx.test_loop._pg_chi2(pg, s1, R1, t1)
    chi = jx.test_loop._pg_chi2(pg, s.numpy(), R.numpy(), t.numpy())
    assert chi < 1.05 * chi_1 + 1e-6


# ------------------------------------------------- a world of one, bit for bit
def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [x for y in tree for x in _leaves(y)]
    return []


def _unsharded_step(wnd, calib, cfg):
    """sharded_ba_step's algebra on one device (tests/test_dist.py's
    reference)."""
    F = cfg.max_frames
    fr, pts = wnd.frames, wnd.points
    lin = tba.linearize(fr, pts, calib, cfg)
    active = topt._residual_grid_mask(fr, pts) & (lin.new_state == TW.RES_IN)
    AH, AT = tba.compute_adjoints(fr)
    sys = tba.accumulate(lin, active, pts.host, AH, AT, F)
    pt_active = (pts.status == TW.PT_ACTIVE) & (active.sum(1) > 0)
    H_sc, b_sc, HdiF = tba.schur_complement(sys, pts.prior, pt_active)
    prior_diag, prior_b = topt._prior_vectors(fr, calib, cfg)
    x = topt.solve_camera_system(
        sys.H, sys.b, H_sc, b_sc, wnd.HM, wnd.bM, topt._stitched_delta(fr, calib),
        prior_diag, prior_b, topt._slot_mask(fr),
        tba.nullspace_projector(tba.nullspaces(fr), cfg.solver_mode_delta),
        cfg.fix_lambda, False, cfg)
    E = torch.where(active, lin.energy, 0.0).sum()
    rmse = torch.sqrt(E / torch.clamp(8.0 * active.sum(), min=1.0))
    return rmse, fr.state - x[CPARS:].reshape(F, 8) * fr.valid[:, None], \
        tba.resubstitute(sys, HdiF, x)


def _world_of_one_pair(name, inputs, mesh):
    wnd, calib, cfg = inputs["synth"]
    if name == "step":
        return sharded_ba_step(mesh, wnd, calib, cfg), _unsharded_step(wnd, calib, cfg)
    if name == "optimize":
        w, c, cfg = inputs["cond"]
        return (sharded_ba_optimize(mesh, w, c, cfg, 4), topt.ba_optimize(w, c, cfg, 4))
    if name == "marginalize":
        tm, td = inputs["marg"]
        return (sharded_marginalize_points(mesh, wnd, calib, tm, td, cfg),
                topt.marginalize_points(wnd, calib, tm, td, cfg))
    if name == "pcg":
        return (sharded_optimize_pose_graph_pcg(mesh, inputs["pg"], n_iters=8, cg_iters=400),
                tpg.optimize_pose_graph_pcg(inputs["pg"], n_iters=8, cg_iters=400))
    return (tgba.sharded_global_ba(mesh, inputs["gba"], inputs["K"], n_iters=4, cg_iters=60),
            tgba.global_ba(inputs["gba"], inputs["K"], n_iters=4, cg_iters=60))


@pytest.mark.parametrize("name", ["step", "optimize", "marginalize", "pcg", "global_ba"])
def test_world_of_one_equals_unsharded(inputs, mesh1, name):
    """The collectives of a world of one change no bit (an all_gather may
    turn a -0.0 into +0.0, which torch.equal accepts)."""
    n0 = mesh1.n_collectives
    sharded, plain = _world_of_one_pair(name, inputs, mesh1)
    assert mesh1.n_collectives > n0
    a, b = _leaves(sharded), _leaves(plain)
    assert len(a) == len(b) > 0
    bad = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    assert not bad, bad


# ----------------------------------------------------------- two ranks
def _two_rank_worker(mesh, inp):
    """Every sharded call on one rank of two; returns numpy."""
    torch.set_num_threads(1)
    from hslam_tpu_torch.models.system import SLAMSystem
    wnd, calib, cfg = inp["synth"]
    out = dict(step=sharded_ba_step(mesh, wnd, calib, cfg))
    w, c, cfg_c = inp["cond"]
    r = sharded_ba_optimize(mesh, w, c, cfg_c, 4)
    out["optimize"] = (r.rmse, r.window.frames.state, r.calib.value, r.window.points.idepth,
                       r.window.points.res_state, r.window.frames.energy_th)
    m = sharded_marginalize_points(mesh, wnd, calib, *inp["marg"], cfg)
    out["marginalize"] = (m.HM, m.bM, m.points.status)
    out["pcg"] = sharded_optimize_pose_graph_pcg(mesh.split("edges"), inp["pg"],
                                                 n_iters=8, cg_iters=400)
    p, chis = tgba.sharded_global_ba(mesh.split("kfblocks"), inp["gba"], inp["K"],
                                     n_iters=4, cg_iters=60)
    out["global_ba"] = (chis, p.t, p.R, p.rho)
    # the pipelined constructor on both ranks (C15 repaired): rank 0 sends,
    # rank 1 replays; closed at once, each takes the other's end marks
    slam = SLAMSystem(80.0, 80.0, 63.5, 47.5, 128, 96, cfg, enable_loop_closure=False,
                      sequential=False, device="cpu", dist_mesh=mesh)
    slam.close()
    out["c15"] = (slam._follower == (mesh.rank == 1) and slam._trk_ended
                  and slam._map_thread is None)
    return {k: (v if isinstance(v, bool) else tuple(x.numpy() for x in v))
            for k, v in out.items()}


def test_two_ranks_match_unsharded(inputs):
    """One spawn of two ranks over Gloo on the CPU runs every sharded
    function; both ranks return the same bits, held to the unsharded port
    with tests/test_dist.py's and tests/test_global_ba.py's tolerances."""
    r0, r1 = D.run_ranks(_two_rank_worker, 2, args=(inputs,), backend="gloo", timeout=300)
    for k in r0:
        same = (r0[k] == r1[k] if isinstance(r0[k], bool)
                else all(np.array_equal(x, y) for x, y in zip(r0[k], r1[k])))
        assert same, k
    assert r0["c15"]
    close = np.testing.assert_allclose

    _, st, ds = (x.numpy() for x in _unsharded_step(*inputs["synth"]))
    close(r0["step"][1], st, rtol=5e-2, atol=1e-3)
    close(r0["step"][2], ds, rtol=5e-2, atol=2e-3)

    w, c, cfg = inputs["cond"]
    rs = topt.ba_optimize(w, c, cfg, 4)
    rmse, state, cal, idepth, res_state, eth = r0["optimize"]
    close(rmse, rs.rmse.numpy(), rtol=1e-4)
    close(state, rs.window.frames.state.numpy(), rtol=1e-4, atol=1e-5)
    close(cal, rs.calib.value.numpy(), rtol=1e-5)
    close(idepth, rs.window.points.idepth.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(res_state, rs.window.points.res_state.numpy())
    close(eth, rs.window.frames.energy_th.numpy(), rtol=1e-4)

    wnd, calib, cfg = inputs["synth"]
    ms = topt.marginalize_points(wnd, calib, *inputs["marg"], cfg)
    close(r0["marginalize"][0], ms.HM.numpy(), rtol=1e-4, atol=1e-2)
    close(r0["marginalize"][1], ms.bM.numpy(), rtol=1e-4, atol=1e-2)
    np.testing.assert_array_equal(r0["marginalize"][2], ms.points.status.numpy())

    pg = inputs["pg"]
    s1, R1, t1 = tpg.optimize_pose_graph_pcg(pg, n_iters=8, cg_iters=400)
    s2, R2, t2 = r0["pcg"]
    close(s2, s1.numpy(), rtol=2e-3, atol=2e-4)
    close(t2, t1.numpy(), rtol=0, atol=5e-3)

    def chi(s, R, t):
        g = pg._replace(s=torch.as_tensor(s), R=torch.as_tensor(R), t=torch.as_tensor(t))
        r = tpg.residuals(g, torch.zeros((g.s.shape[0], 7)))
        return float(torch.sum(r * r * g.weight[:, None]))
    assert chi(s2, R2, t2) <= 1.05 * chi(s1, R1, t1) + 1e-6

    ph, chis_h = tgba.global_ba(inputs["gba"], inputs["K"], n_iters=4, cg_iters=60)
    chis, t, R, rho = r0["global_ba"]
    close(chis, chis_h.numpy(), rtol=2e-3)
    close(t, ph.t.numpy(), atol=2e-3)
    close(R, ph.R.numpy(), atol=2e-3)
    close(rho, ph.rho.numpy(), atol=5e-3)


# ------------------------------------------------------------------ slow
def _system_worker(mesh, frames, cfg):
    """tests/test_dist.py::test_system_with_dist_mesh on one rank."""
    torch.set_num_threads(1)
    from hslam_tpu_torch.models.system import SLAMSystem
    slam = SLAMSystem(80.0, 80.0, 63.5, 47.5, 128, 96, cfg, device="cpu", dist_mesh=mesh)
    for i, f in enumerate(frames):
        slam.process_frame(f, i / 10.0)
        assert not slam.is_lost, f"lost at frame {i}"
    slam.close()
    return (slam.initialized, slam.next_kf_id, mesh.n_collectives,
            [(s.id, s.pose_valid, s.is_kf, s.tracking_ref is not None, s.cam_to_world)
             for s in slam.shells])


@pytest.mark.slow
def test_system_with_dist_mesh_two_ranks(jx):
    """The counterpart of tests/test_dist.py::test_system_with_dist_mesh: the
    port's SLAMSystem on two ranks (Gloo, CPU), 14 frames of that test's
    scene, BA and point marginalization point-sharded; the ranks' shells are
    the same bits and the ATE is that test's bar."""
    import test_system
    from hslam_tpu.utils import lie
    from hslam_tpu_torch.io.trajectory import ate_rmse
    cfg = Config(max_frames=6, max_points=512, max_immature=512, max_features=512,
                 pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
                 desired_point_density=400.0, desired_immature_density=300.0,
                 tracker_iters_per_level=(6, 10, 10))
    I0 = test_system.make_texture()
    gt, frames = [], []
    for i in range(14):
        t = i / 10.0
        xi = jx.jnp.array([0.35 * np.sin(0.5 * t), 0.18 * (1 - np.cos(0.5 * t)), 0.05 * t,
                           0.015 * np.sin(0.4 * t), 0.025 * t, 0.01 * np.sin(0.3 * t)])
        R, tt = lie.se3_exp(xi)
        gt.append((np.asarray(R), np.asarray(tt)))
        frames.append(np.asarray(test_system.render(I0, R, tt)))
    r0, r1 = D.run_ranks(_system_worker, 2, args=(frames, cfg), backend="gloo", timeout=900)
    assert r0[:2] == r1[:2] and r0[2] > 0
    for a, b in zip(r0[3], r1[3]):
        assert a[:4] == b[:4] and np.array_equal(a[4], b[4])
    initialized, n_kf, _, shells = r0
    assert initialized and n_kf >= 3
    est, gtp = [], []
    for sid, valid, is_kf, tracked, c2w in shells:
        if valid and tracked or is_kf:
            Tcw = np.eye(4)
            Tcw[:3, :3], Tcw[:3, 3] = gt[sid]
            gtp.append(np.linalg.inv(Tcw)[:3, 3])
            est.append(c2w[:3, 3])
    err = ate_rmse(np.array(gtp), np.array(est))
    assert np.isfinite(err) and err < 0.15, f"ATE too high: {err}"


def _global_ba_worker(mesh, part, K):
    torch.set_num_threads(1)
    p, chis = tgba.sharded_global_ba(mesh, part, K, n_iters=5, cg_iters=150)
    return to_numpy(p), chis.numpy()


@pytest.mark.slow
def test_256kf_sharded_long_trajectory(jx):
    """The counterpart of tests/test_global_ba.py's 256-keyframe test on four
    ranks (Gloo, CPU): the sharded relaxation recovers the trajectory as well
    as one rank does, and as the JAX package's relaxation of the same
    problem. That test's own bar (ATE below 0.3x the perturbed one) fails in
    both packages: 0.02553 -> 0.02615 in the JAX package (ROADMAP C16)."""
    g = jx.test_global_ba
    gt, noisy = g._make_problem(N=256, ppk=4, radius=3, pose_noise=0.015, seed=6)
    part = tgba.partition_problem(_port(jx, noisy), 4)
    K = jx.jnp.asarray(g.K, jx.jnp.float32)
    p_j, _ = jx.jax.jit(lambda p: jx.jgba.global_ba(p, K, n_iters=5, cg_iters=150))(
        jx.jgba.partition_problem(noisy, 4))
    err_j = g._pose_err(p_j, gt)
    (p_s, chis_s), *_ = D.run_ranks(_global_ba_worker, 4, args=(part, g.K), timeout=900)
    err_s = g._pose_err(p_s, gt)
    assert np.all(np.isfinite(chis_s))
    p_h, _ = tgba.global_ba(part, g.K, n_iters=5, cg_iters=150)
    err_h = g._pose_err(to_numpy(p_h), gt)
    assert err_s <= 1.05 * err_h + 1e-4, f"sharded ATE {err_s} worse than one rank {err_h}"
    assert err_s <= 1.05 * err_j + 1e-4, f"sharded ATE {err_s} worse than the JAX package's {err_j}"


@pytest.mark.slow
def test_dryrun_multichip_four_ranks():
    from hslam_tpu_torch.parallel.dryrun import dryrun_multichip
    assert "ok" in dryrun_multichip(4, device="cpu")
