"""Card-only tests of the port: the hand-written pyramid kernel against its
plain torch version on the same CUDA tensors, the wrapper's refusals, and
the hybrid modules (features, matching, init refinement, PnP, the fused
track_step) on CUDA against the CPU, and the point-sharded BA over a world
of one on NCCL. Every test here needs a CUDA device and skips without one. The file imports no jax, so on a GPU host without jax it runs without
tests/conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from hslam_tpu_torch.ops import pyramid as P

torch.set_num_threads(1)

# tolerances of tests/test_pallas.py: levels differ only by f32 summation
# order of the 2x2 mean; g2 is a square of differences (values up to ~1e4)
LEVEL_ATOL = 1e-4
G2_RTOL, G2_ATOL = 1e-5, 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pyramid kernel has no CPU mode")
    return torch.device("cuda")


def _img(h, w, seed):
    return np.random.default_rng(seed).uniform(0.0, 255.0, (h, w)).astype(np.float32)


SHAPES = [(480, 640), (481, 643), (1, 1), (3, 5), (65, 67), (7, 130), (1100, 1500)]


def _depth(h, w):
    return min(P.MAX_LEVELS, int(np.log2(min(h, w))) + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("gamma", [False, True], ids=["plain", "gamma"])
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype, gamma):
    """Every depth the shape has: without a tail (up to 4 levels), with it,
    and the sizes below one tile; 1100x1500 takes the tail through device
    memory. One kernel launch per pyramid."""
    base = _img(*shape, seed=11)
    img = torch.from_numpy(np.round(base).astype(np.uint8) if dtype == "uint8" else base)
    img = img.to(cuda_device)
    gw = (torch.linspace(0.5, 1.5, 256, device=cuda_device) if gamma else None)
    for n in range(1, _depth(*shape) + 1):
        launches, plain = P.kernel_launches, P.plain_calls
        lv, gr = P.build_direct_pyramid(img, n, gw)
        torch.cuda.synchronize()
        assert P.kernel_launches == launches + 1 and P.plain_calls == plain
        lp, gp = P.build_direct_pyramid_plain(img.float(), n, gw)
        for a, b in zip(lv, lp):
            assert a.shape == b.shape and a.is_contiguous()
            torch.testing.assert_close(a, b, rtol=0.0, atol=LEVEL_ATOL)
        for a, b in zip(gr, gp):
            assert a.shape == b.shape and a.is_contiguous()
            torch.testing.assert_close(a, b, rtol=G2_RTOL, atol=G2_ATOL)


@pytest.mark.gpu
def test_uint8_frame_is_cast_then_launched(cuda_device):
    """A uint8 frame goes to the kernel as it is (converted on load), in one
    launch, and gives the float32 frame's pyramid."""
    img = torch.from_numpy(np.round(_img(48, 64, 2)).astype(np.uint8)).to(cuda_device)
    launches = P.kernel_launches
    lv, gr = P.build_direct_pyramid(img, 3)
    torch.cuda.synchronize()
    assert P.kernel_launches == launches + 1
    lp, gp = P.build_direct_pyramid_plain(img.float(), 3)
    for a, b in zip(lv + gr, lp + gp):
        torch.testing.assert_close(a, b, rtol=G2_RTOL, atol=LEVEL_ATOL)
    lf, gf = P.build_direct_pyramid(img.float(), 3)
    assert all(torch.equal(a, b) for a, b in zip(lv + gr, lf + gf))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(480, 640), (481, 643), (65, 67)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_per_level_and_plain_agree(cuda_device, shape):
    """The fused kernel, the per-level yardstick and the plain version: the two
    kernels bit for bit (same arithmetic, same contraction), both within the
    tolerances of the plain version."""
    img = torch.from_numpy(np.round(_img(*shape, seed=5)).astype(np.uint8)).to(cuda_device)
    gw = torch.linspace(0.5, 1.5, 256, device=cuda_device)
    n = min(6, _depth(*shape))
    launches, per_level = P.kernel_launches, P.per_level_launches
    lv, gr = P.build_direct_pyramid(img, n, gw)
    lo, go = P.build_direct_pyramid_cuda_per_level(img, n, gw)
    torch.cuda.synchronize()
    assert P.kernel_launches == launches + 1 and P.per_level_launches == per_level + n
    lp, gp = P.build_direct_pyramid_plain(img.float(), n, gw)
    for a, b, c in zip(lv + gr, lo + go, lp + gp):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=G2_RTOL, atol=G2_ATOL)


@pytest.mark.gpu
def test_repeated_and_two_thread_calls_give_identical_bits(cuda_device):
    """100 calls in a row on one stream, then two Python threads at once: the
    kernel's block counter is back at 0 after every launch, so every call
    gives the first call's bits."""
    import threading
    img = torch.from_numpy(np.round(_img(480, 640, 9)).astype(np.uint8)).to(cuda_device)
    gw = torch.linspace(0.5, 1.5, 256, device=cuda_device)
    ref = torch.cat([x.reshape(-1) for x in sum(P.build_direct_pyramid(img, 6, gw), [])])
    launches = P.kernel_launches

    def run(n, out):
        for _ in range(n):
            lv, gr = P.build_direct_pyramid(img, 6, gw)
            out.append(torch.cat([x.reshape(-1) for x in lv + gr]))

    outs = []
    run(100, outs)
    a, b = [], []
    threads = [threading.Thread(target=run, args=(50, o)) for o in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert P.kernel_launches == launches + 200
    assert all(torch.equal(o, ref) for o in outs + a + b)


@pytest.mark.gpu
def test_launch_into_a_kept_buffer(cuda_device):
    """launch_pyramid writes the levels where pyramid_views finds them and
    nothing else: the padding between the sub-buffers keeps its bits."""
    img = torch.from_numpy(_img(65, 67, 4)).to(cuda_device)
    lay = P.pyramid_layout(65, 67, 6)
    buf = torch.full((lay.total + 8,), float("nan"), device=cuda_device)
    assert P.launch_pyramid(img, buf, 6) == lay
    torch.cuda.synchronize()
    lv, gr = P.pyramid_views(buf, lay)
    lp, gp = P.build_direct_pyramid_plain(img, 6)
    assert all(torch.equal(a, b) for a, b in zip(lv, lp))
    written = sum(x.numel() for x in lv + gr)
    assert int(torch.isnan(buf).sum()) == buf.numel() - written


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    img = torch.from_numpy(_img(32, 32, 3)).to(cuda_device)
    with pytest.raises(ValueError):            # gamma weight on another device
        P.build_direct_pyramid(img, 2, torch.ones(256))
    with pytest.raises(ValueError):            # gamma weight of the wrong size
        P.build_direct_pyramid(img, 2, torch.ones(255, device=cuda_device))
    with pytest.raises(ValueError):            # more levels than the image has
        P.build_direct_pyramid(img[:4, :4].contiguous(), 4)
    with pytest.raises(ValueError):            # more levels than the kernel takes
        P.build_direct_pyramid(torch.zeros(1024, 1024, device=cuda_device), 9)
    with pytest.raises(ValueError):            # a buffer that is too small
        P.launch_pyramid(img, torch.empty(16, device=cuda_device), 2)
    launches = P.kernel_launches               # float64 is cast, then launched once
    lv, _ = P.build_direct_pyramid(img.double(), 2)
    assert P.kernel_launches == launches + 1 and lv[0].dtype == torch.float32


# ------------------------------------------------- hybrid modules, CUDA vs CPU
def _scene_pair(h=96, w=128, fx=80.0):
    from hslam_tpu_torch.io.synthetic import Scene, se3_exp_np
    sc = Scene(h, w, fx, n_blobs=16)
    R, t = se3_exp_np(np.array([0.03, 0.01, 0.0, 0.003, -0.004, 0.002]))
    a = np.round(sc.render(np.eye(3), np.zeros(3))).astype(np.float32)
    b = np.round(sc.render(R, t)).astype(np.float32)
    return a, b, R, t


@pytest.mark.gpu
def test_features_and_matching_cuda_vs_cpu(cuda_device):
    from hslam_tpu_torch.ops import features as FT
    a, b, _, _ = _scene_pair()
    outs = {}
    for dev in (torch.device("cpu"), cuda_device):
        ea = FT.extract_multiscale(torch.from_numpy(a).to(dev), 4, 256, 8.0)
        eb = FT.extract_multiscale(torch.from_numpy(b).to(dev), 4, 256, 8.0)
        outs[dev.type] = [x.cpu() for x in ea] + [x.cpu() for x in eb]
    c, g = outs["cpu"], outs["cuda"]
    for k in (0, 6):
        cu, cv, cl, _, cd, cval = c[k:k + 6]
        gu, gv, gl, _, gd, gval = g[k:k + 6]
        assert torch.equal(cval, gval) and int(cval.sum()) > 100
        same = (cu == gu) & (cv == gv) & (cl == gl)
        assert bool(same[cval].all())
        assert torch.equal(cd[same], gd[same])
    # matching the CPU descriptors on both devices: integer work, identical
    mi_c, mok_c = FT.match_pair(c[4], c[5], c[10], c[11])
    mi_g, mok_g = FT.match_pair(*(x.to(cuda_device) for x in (c[4], c[5], c[10], c[11])))
    assert torch.equal(mok_c, mok_g.cpu()) and int(mok_c.sum()) > 30
    assert torch.equal(mi_c, mi_g.cpu())


@pytest.mark.gpu
def test_pnp_and_init_refine_cuda_vs_cpu(cuda_device):
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.ops.init_refine import direct_refine
    from hslam_tpu_torch.ops.pnp import pnp_samples, solve_pnp
    from hslam_tpu_torch.ops.pyramid import build_direct_pyramid
    from hslam_tpu_torch.utils import lie
    a, b, R, t = _scene_pair()
    rng = np.random.default_rng(1)
    P = 128
    u = rng.uniform(8, 120, P).astype(np.float32)
    v = rng.uniform(8, 88, P).astype(np.float32)
    id0 = (0.5 * (1 + 0.15 * rng.standard_normal(P))).astype(np.float32)
    tri = rng.uniform(size=P) < 0.7
    xi0 = (np.array([0.03, 0.01, 0.0, 0.003, -0.004, 0.002])
           * (1 + 0.1 * rng.standard_normal(6))).astype(np.float32)
    X = np.stack([rng.uniform(-2, 2, 100), rng.uniform(-1.5, 1.5, 100),
                  rng.uniform(3, 8, 100)], -1).astype(np.float32)
    Xc = X @ R.T + t
    obs = np.stack([80 * Xc[:, 0] / Xc[:, 2] + 64, 80 * Xc[:, 1] / Xc[:, 2] + 48], -1)
    obs = (obs + rng.normal(0, 0.3, obs.shape)).astype(np.float32)
    samples = pnp_samples(torch.ones(100, dtype=torch.bool), 64, 3)
    res = {}
    for dev in (torch.device("cpu"), cuda_device):
        pa, _ = build_direct_pyramid(torch.from_numpy(a).to(dev), 1)
        pb, _ = build_direct_pyramid(torch.from_numpy(b).to(dev), 1)
        R0, t0 = lie.se3_exp(torch.from_numpy(xi0).to(dev))
        r = direct_refine(pa[0], pb[0], torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev),
                          torch.ones(P, dtype=torch.bool, device=dev),
                          torch.from_numpy(id0).to(dev), torch.from_numpy(tri).to(dev), R0, t0,
                          torch.tensor([80.0, 80.0, 63.5, 47.5], device=dev), Config())
        K = torch.tensor([[80.0, 0, 64], [0, 80.0, 48], [0, 0, 1]], device=dev)
        p = solve_pnp(torch.from_numpy(X).to(dev), torch.from_numpy(obs).to(dev),
                      torch.ones(100, dtype=torch.bool, device=dev), K,
                      samples=samples.to(dev))
        res[dev.type] = [x.cpu() for x in (r.R, r.t, p.R, p.t, p.ok)]
    for c, g in zip(res["cpu"], res["cuda"]):
        torch.testing.assert_close(g.float(), c.float(), rtol=0, atol=1e-4)
    assert bool(res["cuda"][4])


@pytest.mark.gpu
def test_track_step_launches_the_kernel(cuda_device):
    """track_step on a uint8 CUDA frame builds its pyramid with the kernel
    (one launch for all levels) and agrees with the CPU run."""
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.ops import tracker as T
    a, b, R, t = _scene_pair()
    cfg = Config(pyr_levels=3, tracker_iters_per_level=(6, 10, 10))
    rng = np.random.default_rng(4)
    gy, gx = np.mgrid[6:90:3, 6:122:3]
    u = gx.ravel().astype(np.float32)
    v = gy.ravel().astype(np.float32)
    w = rng.uniform(0.5, 2.0, u.size).astype(np.float32)
    frame = np.clip(b, 0, 255).astype(np.uint8)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        pyr, _ = P.build_direct_pyramid(torch.from_numpy(a).to(dev), 3)
        tpl = T.build_template(*(torch.from_numpy(x).to(dev) for x in (u, v)),
                               torch.full((u.size,), 0.5, device=dev),
                               torch.from_numpy(w).to(dev),
                               torch.ones(u.size, dtype=torch.bool, device=dev), pyr)
        eye = torch.eye(4, device=dev)
        one = torch.tensor(1.0, device=dev)
        launches = P.kernel_launches
        o = T.track_step(tpl, torch.from_numpy(frame).to(dev),
                         torch.tensor([80.0, 80.0, 63.5, 47.5], device=dev), eye, eye, eye,
                         False, torch.zeros(2, device=dev), one, one,
                         torch.zeros(2, device=dev), cfg, 3)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert P.kernel_launches == launches + 1
        out[dev.type] = [x.cpu() for x in (o.R, o.t, o.ok)]
    assert bool(out["cpu"][2]) and bool(out["cuda"][2])
    # f32 reductions in another order on the card (chip_smoke.py phase 4)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["cuda"][1].numpy(), t, atol=3e-3)


@pytest.mark.gpu
def test_system_runs_on_the_card_by_default(cuda_device):
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.models.system import SLAMSystem
    slam = SLAMSystem(80.0, 80.0, 63.5, 47.5, 128, 96, Config(pyr_levels=3),
                      enable_loop_closure=False)
    assert slam.device.type == "cuda" and slam.window.frames.images.device.type == "cuda"
    slam.close()


@pytest.mark.gpu
def test_world_of_one_nccl_sharded_ba_equals_unsharded(cuda_device, tmp_path):
    """The point-sharded BA optimize and point marginalization over a world
    of one on NCCL give the unsharded bits on the card."""
    import torch.distributed as dist

    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.models import optimizer as opt
    from hslam_tpu_torch.parallel import distributed as D
    from hslam_tpu_torch.parallel.dist_ba import (sharded_ba_optimize,
                                                  sharded_marginalize_points)
    from hslam_tpu_torch.parallel.dryrun import ba_inputs
    cfg = Config(max_frames=8, max_points=2048, pyr_levels=2)
    wnd, calib = ba_inputs(cfg, device="cuda")
    D.initialize(f"file://{tmp_path}/rdv", 1, 0, "nccl")
    try:
        mesh = D.global_mesh("points")
        a, b = sharded_ba_optimize(mesh, wnd, calib, cfg, 4), opt.ba_optimize(wnd, calib, cfg, 4)
        tm = torch.arange(cfg.max_points, device="cuda") % 5 == 0
        td = (torch.arange(cfg.max_points, device="cuda") % 7 == 3) & ~tm
        ma = sharded_marginalize_points(mesh, a.window, a.calib, tm, td, cfg)
        mb = opt.marginalize_points(b.window, b.calib, tm, td, cfg)
        torch.cuda.synchronize()
        assert mesh.n_collectives > 0
    finally:
        dist.destroy_process_group()

    def leaves(t):
        return [t] if isinstance(t, torch.Tensor) else (
            [x for y in t for x in leaves(y)] if isinstance(t, tuple) else [])
    for x, y in zip(leaves((a, ma)), leaves((b, mb))):
        assert torch.equal(x, y)
