"""Smoke test of the PyTorch + CUDA port (hslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure is fatal; nothing falls back to the CPU):
  1. environment: card name and power limit, torch/CUDA versions, TF32 off;
  2. build the CUDA pyramid kernels (the fused one and the per-level
     yardstick, one library) from csrc/ with nvcc, printing what ptxas
     says of each;
  3. the fused kernel vs its plain torch version on the card (seven shapes
     from 1x1 to 1100x1500, uint8 and float32, 1 to 8 levels, with/without a
     gamma weight), then timed for the main path's call (480x640 uint8, 6
     levels) in turns with the per-level kernel and the plain version: the
     call (CUDA events around the wrapper) and the kernels alone (spans of
     back-to-back launches, warm and with a 64 MB write before each), held
     against the memory bound;
  4. device parity: the coarse tracker and one windowed BA from the same
     state on CUDA and on the CPU;
  5. the direct-only path: SLAMSystem.process_frame on the card over 60
     frames of the 640x480 synthetic arc with bench.py's capacities, checked
     for initialization, keyframes, lost frames, ATE and kernel launches (one
     per pyramid);
  6. hybrid device parity: feature extraction, matching, the init
     refinement and PnP on one 480x640 frame, on CUDA and on the CPU;
  7. the main path: the default (hybrid) configuration through
     process_frame_pipelined with the mapping thread, 60 frames, checked for
     initialization, keyframes, valid poses, ATE, indirect observations in
     the BA and pyramid kernel launches, with fps and latencies printed;
  8. relocalization on the card: the kidnapped camera (pose jump plus 4x
     gain) through the sequential hybrid system.

Prints a JSON kernel table on the line before the last, and as the last
line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEQ_FRAMES = 60
# JAX package (hslam_tpu, XLA:CPU) on the same 60-frame sequence: Sim3-aligned
# ATE and keyframe count, for the direct-only configuration of phase 5
# (sequential) and the default hybrid one of phase 7 (pipelined); PERF.md
JAX_CPU_ATE = 0.0027565803515872665
JAX_CPU_KFS = 4
JAX_CPU_ATE_HYBRID = 0.002784366471442508
JAX_CPU_KFS_HYBRID = 5
LEVEL_ATOL = 1e-4            # tests/test_pallas.py: 0.25*sum vs mean, f32 order
G2_RTOL, G2_ATOL = 1e-5, 1e-2


def log(msg):
    print(msg, flush=True)


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    import hslam_tpu_torch  # noqa: F401  (sets the numerics policy)
    log(f"[env] {card}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    log(f"[env] tf32 matmul={tf32[0]} cudnn={tf32[1]} precision={tf32[2]}")
    if tf32[0] or tf32[1] or tf32[2] != "highest":
        raise RuntimeError("TF32 must be off for the window Hessians")
    return card


def phase_build():
    from hslam_tpu_torch import _cuda
    from hslam_tpu_torch.ops import pyramid as P
    t0 = time.perf_counter()
    P._kernels()
    log(f"[build] pyramid.cu (fused + per-level entries) built+loaded in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {_cuda.build_seconds.get('pyramid', 0.0):.2f}s)")
    lines = _cuda.ptxas_log["pyramid"].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "pyramid_" in line:
            name = "fused<uint8>" if "fused_kernelIh" in line else (
                "fused<float32>" if "fused_kernelIf" in line else "per-level")
            used = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                            if "Used" in x or "spill" in x)
            log(f"[build] ptxas {name}: {used}")


def _cuda_ms(fn, reps=50, warm=5):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _span_ms(fn, n):
    """Device time per call of fn: CUDA events around n back-to-back calls,
    enqueued while the card is kept busy (a ~20 ms spin kernel first), so
    that the span holds the device's work and not the host's enqueueing.
    Keep n calls below the depth of CUDA's launch queue (~1000 operations)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


# shapes of phase 3: the main path's frame, odd sizes (scalar stores, ragged
# tiles), sizes below one tile, and one whose level 4 does not fit the last
# block's shared memory (the tail then goes through device memory)
KERNEL_SHAPES = [(480, 640), (481, 643), (1, 1), (3, 5), (65, 67), (7, 130), (1100, 1500)]
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA's data sheet (SXM)


def _max_levels(H, W):
    return min(8, int(np.log2(min(H, W))) + 1)


def phase_kernel():
    from hslam_tpu_torch.ops import pyramid as P
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    gw = torch.linspace(0.5, 1.5, 256).to(dev)
    worst, n_cases = 0.0, 0
    for H, W in KERNEL_SHAPES:
        base = torch.rand((H, W), generator=g) * 255.0
        top = _max_levels(H, W)
        depths = sorted({1, 3, 4, min(6, top), top} & set(range(1, top + 1)))
        for kind in ("f32", "u8"):
            img = (base.round().to(torch.uint8) if kind == "u8" else base).to(dev)
            for n in depths:
                for weight in (None, gw):
                    lv, gr = P.build_direct_pyramid(img, n, weight)
                    torch.cuda.synchronize()
                    lp, gp = P.build_direct_pyramid_plain(img.float(), n, weight)
                    err_lv = max(float((a - b).abs().max()) for a, b in zip(lv, lp))
                    err_g2 = max(float((a - b).abs().max()) for a, b in zip(gr, gp))
                    for a, b in zip(lv + gr, lp + gp):
                        if a.shape != b.shape or not a.is_contiguous():
                            raise AssertionError(f"pyramid view {tuple(a.shape)} vs "
                                                 f"{tuple(b.shape)} at {H}x{W} n={n}")
                    for a, b in zip(gr, gp):
                        torch.testing.assert_close(a, b, rtol=G2_RTOL, atol=G2_ATOL)
                    if not err_lv <= LEVEL_ATOL:
                        raise AssertionError(f"pyramid levels differ by {err_lv} > {LEVEL_ATOL} "
                                             f"at {kind} {H}x{W} n={n}")
                    worst = max(worst, err_lv, err_g2)
                    n_cases += 1
            log(f"[kernel] {kind} {H}x{W} levels {depths} with/without gamma: "
                f"worst so far max|d|={worst:.3g}")
    # the per-level yardstick computes the same function
    img = (torch.rand((480, 640), generator=g) * 255).to(torch.uint8).to(dev)
    lv, gr = P.build_direct_pyramid(img, 6, gw)
    lo, go = P.build_direct_pyramid_cuda_per_level(img, 6, gw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(lv + gr, lo + go))
    log(f"[kernel] {n_cases} cases agree with the plain version; fused == per-level "
        f"bit for bit at 480x640 uint8 with gamma: {same}")
    if not same:
        raise AssertionError("fused and per-level kernels differ")

    # ---- timing, the main path's call: uint8 480x640 frame -> 6-level pyramid
    frame = (torch.rand((480, 640), generator=g) * 255).to(torch.uint8).to(dev)
    lay = P.pyramid_layout(480, 640, 6)
    n_bytes = frame.numel() * frame.element_size() + 16 * sum(h * w for h, w in lay.shapes)
    bound_ms = 1e3 * n_bytes / H100_BYTES_PER_S
    runs = {"plain": lambda: P.build_direct_pyramid_plain(frame.float(), 6),
            "per_level": lambda: P.build_direct_pyramid_cuda_per_level(frame, 6),
            "fused": lambda: P.build_direct_pyramid(frame, 6)}
    order = ("plain", "per_level", "fused", "fused", "per_level", "plain")
    call = [(k, _cuda_ms(runs[k])) for k in order]
    log("[kernel] 480x640 uint8 6 levels, call_ms, CUDA events around the wrapper, median of "
        "50, in turns: " + " ".join(f"{k} {t:.4f}" for k, t in call))
    call_ms = {k: min(t for kk, t in call if kk == k) for k in runs}

    # the kernels alone: back-to-back launches into preallocated buffers
    buf = torch.empty(lay.total, dtype=torch.float32, device=dev)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    f32 = frame.float()
    lvl_bufs = [(torch.empty((h, w, 3), device=dev), torch.empty((h, w), device=dev),
                 torch.empty((h // 2, w // 2), device=dev)) for h, w in lay.shapes]
    _, level_fn = P._kernels()
    stream = torch.cuda.current_stream().cuda_stream

    def per_level_into():
        # the cast and the six launches of the earlier design, nothing allocated
        src = f32.copy_(frame)
        for (o3, g2, down) in lvl_bufs:
            level_fn(src.data_ptr(), o3.data_ptr(), g2.data_ptr(), down.data_ptr(), None,
                     o3.shape[0], o3.shape[1], stream)
            src = down

    def fused_into():
        P.launch_pyramid(frame, buf, 6)

    def cold(fn):
        def run():
            flush.fill_(1)      # 64 MB written: the 50 MB L2 holds nothing of the frame
            fn()
        return run

    dev_ms = {}
    # launches per span: 200 of the fused kernel; 100 of the per-level design,
    # which is 7 kernels a call (8 with the write before it)
    for name, fn, n in (("per_level", per_level_into, 100), ("fused", fused_into, 200)):
        for _ in range(20):
            fn()
        warm = [_span_ms(fn, n) for _ in range(5)]
        flush_only = [_span_ms(lambda: flush.fill_(1), n) for _ in range(5)]
        with_flush = [_span_ms(cold(fn), n) for _ in range(5)]
        dev_ms[name] = (float(np.median(warm)),
                        float(np.median(with_flush)) - float(np.median(flush_only)))
        log(f"[kernel] {name}: device_ms {dev_ms[name][0]:.5f} (5 spans of {n} calls: "
            f"{' '.join(f'{t:.5f}' for t in warm)}); device_ms_cold {dev_ms[name][1]:.5f} "
            f"(with a 64 MB write before each launch {float(np.median(with_flush)):.5f}, "
            f"the write alone {float(np.median(flush_only)):.5f})")
    # where the fused kernel's time goes: the launch floor (a 1x1 image) and
    # the frame at 1, 3, 4 (no hand-over) and 6 levels (hand-over and tail)
    dot = torch.zeros((1, 1), dtype=torch.uint8, device=dev)
    depth_ms = {"1x1": float(np.median([_span_ms(lambda: P.launch_pyramid(dot, buf, 1), 200)
                                        for _ in range(3)]))}
    for n in (1, 3, 4, 6):
        depth_ms[str(n)] = float(np.median(
            [_span_ms(lambda: P.launch_pyramid(frame, buf, n), 200) for _ in range(3)]))
    log("[kernel] fused device_ms by depth: " + " ".join(
        f"{k} {v:.5f}" for k, v in depth_ms.items()) + " (1x1: one block, one level)")
    lv2, gr2 = P.pyramid_views(buf, lay)
    lp, gp = P.build_direct_pyramid_plain(frame.float(), 6)
    if not all(torch.equal(a, b) for a, b in zip(lv2, lp)):
        raise AssertionError("the timed launches left a wrong pyramid")
    device_ms, device_ms_cold = dev_ms["fused"]
    share = bound_ms / device_ms
    log(f"[kernel] bound_ms {bound_ms:.5f} ({n_bytes} B at 3.35 TB/s); share_of_bound "
        f"{share:.4f} warm, {bound_ms / device_ms_cold:.4f} cold; per-level kernels alone "
        f"{dev_ms['per_level'][0]:.5f} warm, {dev_ms['per_level'][1]:.5f} cold")
    if not 0.0 < share <= 1.0:
        raise AssertionError(f"share_of_bound {share} is not in (0, 1]")
    return dict(max_abs_err=worst, ms=device_ms, call_ms=call_ms["fused"],
                device_ms=device_ms, device_ms_cold=device_ms_cold, bound_ms=bound_ms,
                bound_by="bytes", share_of_bound=share, per_level_ms=call_ms["per_level"],
                per_level_device_ms=dev_ms["per_level"][0], plain_ms=call_ms["plain"],
                library_ms=None)


def _small_state():
    """A mid-sequence state made by the port itself on the CPU (96x128)."""
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.io.synthetic import Scene, make_sequence, sweep_xi
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops.pyramid import build_direct_pyramid
    cfg = Config(max_frames=6, max_points=512, max_immature=512, max_features=512,
                 pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
                 desired_point_density=400.0, desired_immature_density=300.0,
                 tracker_iters_per_level=(6, 10, 10), enable_indirect=False,
                 init_direct_refine=False)
    frames, _ = make_sequence(Scene(96, 128, 80.0, n_blobs=16), 9,
                              lambda i: sweep_xi(i / 10.0))
    slam = SLAMSystem(80.0, 80.0, 63.5, 47.5, 128, 96, cfg, enable_loop_closure=False,
                      device="cpu")
    for i, f in enumerate(frames[:8]):
        slam.process_frame(f, 0.1 * i)
    if not slam.initialized or slam.next_kf_id < 2:
        raise RuntimeError("could not build the parity state")
    tries, aff0 = slam._motion_hypotheses()
    T = np.stack((tries + [tries[0]] * 32)[:32])
    pyr, _ = build_direct_pyramid(torch.as_tensor(frames[8]), cfg.pyr_levels)
    return slam, cfg, T, aff0, pyr


def phase_parity():
    from hslam_tpu_torch.convert import from_numpy, to_numpy
    from hslam_tpu_torch.models.optimizer import ba_optimize
    from hslam_tpu_torch.ops.tracker import track_coarse_multi
    slam, cfg, T, aff0, pyr = _small_state()
    outs = {}
    for name in ("cpu", "cuda"):
        dev = torch.device(name)

        def t32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        tpl = from_numpy(to_numpy(slam.template), dev)
        res, best = track_coarse_multi(
            tpl, [p.to(dev) for p in pyr], slam._K_pyr_cache.to(dev),
            t32(T[:, :3, :3]), t32(T[:, :3, 3]), t32(aff0), t32(slam.ref_exposure),
            t32(1.0), t32(slam.ref_aff), cfg, coarsest_lvl=cfg.pyr_levels - 1)
        ba = ba_optimize(from_numpy(to_numpy(slam.window), dev),
                         from_numpy(to_numpy(slam.calib), dev), cfg, 6)
        outs[name] = to_numpy((res.R, res.t, res.residuals, best, ba.window.frames.state,
                               ba.window.points.idepth, ba.rmse))
    c, g = outs["cpu"], outs["cuda"]
    # f32 reductions run in another order on the card; an LM accept/reject
    # flip would show as a pose difference far above these bounds
    checks = [("track R", c[0], g[0], 1e-4), ("track t", c[1], g[1], 1e-4),
              ("track rmse", c[2], g[2], 1e-3), ("ba state", c[4], g[4], 1e-4),
              ("ba idepth", c[5], g[5], 1e-3), ("ba rmse", c[6], g[6], 1e-3)]
    if int(c[3]) != int(g[3]):
        raise AssertionError(f"best hypothesis differs: cpu {c[3]} cuda {g[3]}")
    for name, a, b, tol in checks:
        err = float(np.nanmax(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
        log(f"[parity] {name}: max|cpu-cuda|={err:.3g} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{name} differs between CPU and CUDA by {err}")


def phase_main_path(card):
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.io.synthetic import Scene, make_sequence
    from hslam_tpu_torch.io.trajectory import ate_rmse
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    H, W, FX = 480, 640, 320.0
    cfg = Config(max_frames=8, max_points=2048, max_immature=2048, pyr_levels=6,
                 enable_indirect=False, init_direct_refine=False)
    frames, centres = make_sequence(Scene(H, W, FX), SEQ_FRAMES)
    slam = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, cfg,
                      enable_loop_closure=False, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    P.kernel_launches = 0
    P.plain_calls = 0
    frame_ms, kf_ms = [], []
    t_all = time.perf_counter()
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        shell = slam.process_frame(f, 0.05 * i)
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t0)
        if slam.initialized and shell.tracking_ref is not None:
            (kf_ms if shell.is_kf else frame_ms).append(dt)
    wall = time.perf_counter() - t_all
    launches, plain = P.kernel_launches, P.plain_calls

    valid = [s.id for s in slam.shells if s.pose_valid]
    finite = all(np.all(np.isfinite(s.cam_to_world)) for s in slam.shells)
    ate = ate_rmse(centres[valid], np.array([slam.shells[i].cam_to_world[:3, 3] for i in valid]))
    bar = max(1.5 * JAX_CPU_ATE, 0.02)
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else float("nan")  # noqa: E731
    log(f"[main] {card} | frames {SEQ_FRAMES} wall {wall:.2f}s fps {SEQ_FRAMES / wall:.2f}")
    log(f"[main] tracked-frame ms p50 {pct(frame_ms, 50):.2f} p95 {pct(frame_ms, 95):.2f} "
        f"(n={len(frame_ms)}); keyframe ms p50 {pct(kf_ms, 50):.2f} p95 {pct(kf_ms, 95):.2f} "
        f"(n={len(kf_ms)})")
    log(f"[main] initialized={slam.initialized} keyframes={slam.next_kf_id} "
        f"(JAX CPU {JAX_CPU_KFS}) lost={slam.is_lost} pose_valid={len(valid)}/{SEQ_FRAMES} "
        f"relocs={slam.n_relocs} ATE={ate:.6f} (bar {bar:.4f}, "
        f"JAX CPU {JAX_CPU_ATE:.6f})")
    log(f"[main] pyramid kernel launches {launches} plain calls {plain} "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    failures = []
    if not slam.initialized:
        failures.append("not initialized")
    if slam.next_kf_id < 3:
        failures.append(f"only {slam.next_kf_id} keyframes")
    if slam.is_lost or len(valid) != SEQ_FRAMES or not finite:
        failures.append("lost or invalid/non-finite poses")
    if slam.n_relocs != 0:
        failures.append("relocalization was needed")
    if not ate <= bar:
        failures.append(f"ATE {ate} above {bar}")
    if launches != SEQ_FRAMES or plain != 0:
        failures.append(f"kernel launches {launches} (want {SEQ_FRAMES}, one per pyramid), "
                        f"plain calls {plain}")
    if failures:
        raise AssertionError("main path: " + "; ".join(failures))
    return launches


def _frame_pair(H=480, W=640, fx=320.0):
    """One frame of the synthetic scene and a second one a small motion
    later (worldToCam of the second: (R, t))."""
    from hslam_tpu_torch.io.synthetic import Scene, se3_exp_np
    sc = Scene(H, W, fx)
    R, t = se3_exp_np(np.array([0.04, 0.015, 0.01, 0.004, -0.006, 0.003]))
    a = np.round(sc.render(np.eye(3), np.zeros(3))).astype(np.float32)
    b = np.round(sc.render(R, t)).astype(np.float32)
    return a, b, R, t, fx


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def phase_hybrid_parity():
    """The hybrid modules on one 480x640 frame pair, on CUDA and on the CPU."""
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.ops import features as FT
    from hslam_tpu_torch.ops.init_refine import direct_refine
    from hslam_tpu_torch.ops.pnp import pnp_samples, solve_pnp
    from hslam_tpu_torch.ops.pyramid import build_direct_pyramid
    from hslam_tpu_torch.utils import lie
    a, b, R, t, fx = _frame_pair()
    H, W = a.shape
    cfg = Config()
    out = {}
    for name in ("cpu", "cuda"):
        dev = torch.device(name)
        ext = [FT.extract_multiscale(torch.from_numpy(x).to(dev), cfg.ind_pyr_levels,
                                     cfg.max_kf_features, float(cfg.min_th_fast),
                                     scale=cfg.ind_pyr_scale) for x in (a, b)]
        out[name] = dict(ext=[[y.cpu() for y in e] for e in ext])
    ec, eg = out["cpu"]["ext"], out["cuda"]["ext"]
    for k, (c, g) in enumerate(zip(ec, eg)):
        cu, cv, cl, _, cd, cval = (x.numpy() for x in c)
        gu, gv, gl, _, gd, gval = (x.numpy() for x in g)
        kc = set(zip(cu[cval], cv[cval], cl[cval]))
        kg = set(zip(gu[gval], gv[gval], gl[gval]))
        same = (cu == gu) & (cv == gv) & cval & gval
        log(f"[hybrid] extract_multiscale frame {k}: {int(cval.sum())} keypoints, "
            f"sets equal={kc == kg}, descriptors equal at {int(same.sum())} "
            f"coinciding: {bool((cd[same] == gd[same]).all())}")
        if kc != kg or not (cd[same] == gd[same]).all():
            raise AssertionError("extract_multiscale differs between CPU and CUDA")
    # matching: the CPU descriptors on both devices (integer work)
    m = {}
    for name in ("cpu", "cuda"):
        dev = torch.device(name)
        args = [x.to(dev) for x in (ec[0][4], ec[0][5], ec[1][4], ec[1][5])]
        m[name] = [x.cpu().numpy() for x in FT.match_pair(*args)]
    equal = all((x == y).all() for x, y in zip(m["cpu"], m["cuda"]))
    log(f"[hybrid] match_pair: {int(m['cpu'][1].sum())} matches, identical={equal}")
    if not equal:
        raise AssertionError("match_pair differs between CPU and CUDA")

    # init refinement from the same inputs (tests/test_init_refine.py style)
    rng = np.random.default_rng(0)
    P = 1024
    u = rng.uniform(16, W - 16, P).astype(np.float32)
    v = rng.uniform(16, H - 16, P).astype(np.float32)
    id0 = (0.5 * (1.0 + 0.15 * rng.standard_normal(P))).astype(np.float32)
    tri = rng.uniform(size=P) < 0.7
    xi0 = (np.array([0.04, 0.015, 0.01, 0.004, -0.006, 0.003])
           * (1.0 + 0.1 * rng.standard_normal(6))).astype(np.float32)
    res = {}
    for name in ("cpu", "cuda"):
        dev = torch.device(name)
        pa, _ = build_direct_pyramid(torch.from_numpy(a).to(dev), 1)
        pb, _ = build_direct_pyramid(torch.from_numpy(b).to(dev), 1)
        R0, t0 = lie.se3_exp(torch.from_numpy(xi0).to(dev))
        K4 = torch.tensor([fx, fx, W / 2 - 0.5, H / 2 - 0.5], device=dev)
        r = direct_refine(pa[0], pb[0], *(torch.from_numpy(x).to(dev) for x in (u, v)),
                          torch.ones(P, dtype=torch.bool, device=dev),
                          torch.from_numpy(id0).to(dev), torch.from_numpy(tri).to(dev),
                          R0, t0, K4, cfg)
        res[name] = [x.cpu().numpy() for x in (r.R, r.t, r.good)]
    eR, et = _max_err(res["cpu"][0], res["cuda"][0]), _max_err(res["cpu"][1], res["cuda"][1])
    log(f"[hybrid] direct_refine: max|cpu-cuda| R {eR:.3g} t {et:.3g} (tol 1e-4), "
        f"good {int(res['cpu'][2].sum())}/{int(res['cuda'][2].sum())}")
    if not (eR <= 1e-4 and et <= 1e-4):
        raise AssertionError("direct_refine differs between CPU and CUDA")

    # PnP with fixed draws
    Xw = np.stack([rng.uniform(-2, 2, 400), rng.uniform(-1.5, 1.5, 400),
                   rng.uniform(3.0, 8.0, 400)], -1).astype(np.float32)
    Xc = Xw @ R.T + t
    obs = np.stack([fx * Xc[:, 0] / Xc[:, 2] + W / 2, fx * Xc[:, 1] / Xc[:, 2] + H / 2], -1)
    obs = (obs + rng.normal(0, 0.5, obs.shape)).astype(np.float32)
    obs[:100] = rng.uniform(0, 480, (100, 2))
    valid = torch.ones(400, dtype=torch.bool)
    samples = pnp_samples(valid, 64, 7)
    K = torch.tensor([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
    pp = {}
    for name in ("cpu", "cuda"):
        dev = torch.device(name)
        r = solve_pnp(torch.from_numpy(Xw).to(dev), torch.from_numpy(obs).to(dev),
                      valid.to(dev), K.to(dev), samples=samples.to(dev))
        pp[name] = [x.cpu().numpy() for x in (r.R, r.t, r.ok)]
    eR, et = _max_err(pp["cpu"][0], pp["cuda"][0]), _max_err(pp["cpu"][1], pp["cuda"][1])
    log(f"[hybrid] solve_pnp: ok {bool(pp['cpu'][2])}/{bool(pp['cuda'][2])}, max|cpu-cuda| "
        f"R {eR:.3g} t {et:.3g} (tol 1e-4), |t - truth| {_max_err(pp['cuda'][1], t):.3g}")
    if not (bool(pp["cuda"][2]) and eR <= 1e-4 and et <= 1e-4):
        raise AssertionError("solve_pnp differs between CPU and CUDA")


def _hybrid_cfg():
    from hslam_tpu_torch.config import Config
    # bench.py's capacities; every other field keeps its default
    # (enable_indirect=True, init_direct_refine=True, use_fast=False)
    return Config(max_frames=8, max_points=2048, max_immature=2048, pyr_levels=6)


def phase_pipelined(card):
    """The main path: the default configuration through the pipelined
    entry with the mapping thread."""
    from hslam_tpu_torch.io.synthetic import Scene, make_sequence
    from hslam_tpu_torch.io.trajectory import ate_rmse
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    H, W, FX = 480, 640, 320.0
    cfg = _hybrid_cfg()
    frames, centres = make_sequence(Scene(H, W, FX), SEQ_FRAMES)
    slam = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, cfg, sequential=False,
                      enable_loop_closure=False, device="cuda")
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        P.kernel_launches = 0
        P.plain_calls = 0
        done_ms = []
        t_all = time.perf_counter()
        for i, f in enumerate(frames):
            t0 = time.perf_counter()
            out = slam.process_frame_pipelined(f, 0.05 * i)
            torch.cuda.synchronize()
            if out is not None:
                done_ms.append(1e3 * (time.perf_counter() - t0))
        slam.flush_pipeline()
        slam.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
        launches, plain = P.kernel_launches, P.plain_calls
    finally:
        slam.close()
    valid = [s.id for s in slam.shells if s.pose_valid]
    finite = all(np.all(np.isfinite(s.cam_to_world)) for s in slam.shells)
    ate = ate_rmse(centres[valid], np.array([slam.shells[i].cam_to_world[:3, 3] for i in valid]))
    bar = max(1.5 * JAX_CPU_ATE_HYBRID, 0.02)
    builds = SEQ_FRAMES + slam.n_track_retries
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else float("nan")  # noqa: E731
    ms = lambda xs: [round(1e3 * x, 1) for x in xs]  # noqa: E731
    log(f"[pipelined] {card} | frames {SEQ_FRAMES} wall {wall:.2f}s fps {SEQ_FRAMES / wall:.2f}")
    log(f"[pipelined] per-frame completion ms p50 {pct(done_ms, 50):.2f} "
        f"p95 {pct(done_ms, 95):.2f} (n={len(done_ms)})")
    log(f"[pipelined] kf_latencies ms {ms(slam.kf_latencies)}")
    log(f"[pipelined] kf_full_latencies ms {ms(slam.kf_full_latencies)}")
    log(f"[pipelined] initialized={slam.initialized} keyframes={slam.next_kf_id} "
        f"(JAX CPU {JAX_CPU_KFS_HYBRID}) lost={slam.is_lost} "
        f"pose_valid={len(valid)}/{SEQ_FRAMES} ATE={ate:.6f} (bar {bar:.4f}, "
        f"JAX CPU {JAX_CPU_ATE_HYBRID:.6f}) ind_obs_history={slam.ind_obs_history}")
    log(f"[pipelined] n_track_retries={slam.n_track_retries} "
        f"n_frames_skipped={slam.n_frames_skipped} n_relocs={slam.n_relocs} "
        f"pyramid kernel launches {launches} (builds {builds}) plain calls {plain} "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    failures = []
    if not slam.initialized:
        failures.append("not initialized")
    if slam.next_kf_id < 3 or abs(slam.next_kf_id - JAX_CPU_KFS_HYBRID) > 1:
        failures.append(f"{slam.next_kf_id} keyframes (JAX CPU {JAX_CPU_KFS_HYBRID})")
    if slam.is_lost or len(valid) != SEQ_FRAMES or not finite:
        failures.append("lost or invalid/non-finite poses")
    if not ate <= bar:
        failures.append(f"ATE {ate} above {bar}")
    if sum(slam.ind_obs_history) <= 0:
        failures.append("no indirect observation reached the BA")
    if launches != builds or plain != 0:
        failures.append(f"kernel launches {launches} (want {builds}, one per pyramid), "
                        f"plain calls {plain}")
    if failures:
        raise AssertionError("pipelined main path: " + "; ".join(failures))
    return launches


def phase_relocalization(card):
    """The kidnapped camera of tests/test_system.py at 640x480: from frame
    15 on, a persistent pose offset and a 4x gain on the float frames."""
    from hslam_tpu_torch.io.synthetic import Scene, se3_exp_np, sweep_xi
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    H, W, FX = 480, 640, 320.0
    sc = Scene(H, W, FX)
    dR, dt = se3_exp_np(np.array([0.5, 0.25, 0.0, 0.0, 0.15, 0.0]))
    slam = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, _hybrid_cfg(),
                      enable_loop_closure=False, device="cuda")
    P.kernel_launches = 0
    P.plain_calls = 0
    t0 = time.perf_counter()
    n_frames = 30
    for i in range(n_frames):
        R, t = se3_exp_np(sweep_xi(i / 10.0))
        if i < 15:
            img = sc.render(R, t)
        else:
            img = sc.render(dR @ R, dR @ t + dt) * 4.0
        slam.process_frame(img, i / 10.0)
        if i == 14 and not slam.initialized:
            raise AssertionError("relocalization: not initialized before the kidnap")
    torch.cuda.synchronize()
    launches, plain = P.kernel_launches, P.plain_calls
    first = next((s.id for s in slam.shells if s.relocalized), None)
    tail_ok = all(s.pose_valid for s in slam.shells[-5:])
    log(f"[reloc] {card} | {n_frames} frames in {time.perf_counter() - t0:.2f}s, "
        f"n_relocs={slam.n_relocs} (first at frame {first}) lost={slam.is_lost} "
        f"last 5 valid={tail_ok} pyramid launches {launches} plain calls {plain}")
    if slam.n_relocs < 1 or slam.is_lost or not tail_ok or plain != 0:
        raise AssertionError("relocalization on the card failed")
    return launches


def main():
    card = phase_environment()
    phase_build()
    kernel = phase_kernel()
    phase_parity()
    launches = phase_main_path(card)
    phase_hybrid_parity()
    launches += phase_pipelined(card)
    launches += phase_relocalization(card)
    log(json.dumps({"kernels": [{
        "name": "pyramid_fused", "route": "cuda",
        "source": "hslam_tpu_torch/csrc/pyramid.cu",
        "replaces": "hslam_tpu/ops/pallas_kernels.py:38",
        "launches": launches, **kernel}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
