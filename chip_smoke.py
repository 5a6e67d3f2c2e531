"""Smoke test of the PyTorch + CUDA port (hslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure is fatal; nothing falls back to the CPU):
  1. environment: card name and power limit, torch/CUDA versions, TF32 off;
  2. build the CUDA pyramid kernel from csrc/ with nvcc;
  3. kernel vs its plain torch version on the card (480x640, 481x643,
     uint8 input, with/without a gamma weight), timed with CUDA events;
  4. device parity: the coarse tracker and one windowed BA from the same
     state on CUDA and on the CPU;
  5. the main path: SLAMSystem.process_frame on the card over 60 frames of
     the 640x480 synthetic arc with bench.py's capacities, checked for
     initialization, keyframes, lost frames, ATE and kernel launches.

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
# JAX package (hslam_tpu, XLA:CPU) on the same 60-frame sequence and slice
# configuration: Sim3-aligned ATE and keyframe count (see PERF.md)
JAX_CPU_ATE = 0.0027565803515872665
JAX_CPU_KFS = 4
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
    P._kernel()
    log(f"[build] pyramid.cu built+loaded in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {_cuda.build_seconds.get('pyramid', 0.0):.2f}s)")


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


def phase_kernel():
    from hslam_tpu_torch.ops import pyramid as P
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    gw = torch.linspace(0.5, 1.5, 256).to(dev)
    worst = 0.0
    cases = [("f32", 480, 640), ("f32", 481, 643), ("u8", 480, 640)]
    for kind, H, W in cases:
        base = torch.rand((H, W), generator=g) * 255.0
        img = (base.round().to(torch.uint8) if kind == "u8" else base).to(dev)
        for weight in (None, gw):
            lv, gr = P.build_direct_pyramid(img, 6, weight)
            torch.cuda.synchronize()
            lp, gp = P.build_direct_pyramid_plain(img.float(), 6, weight)
            err_lv = max(float((a - b).abs().max()) for a, b in zip(lv, lp))
            err_g2 = max(float((a - b).abs().max()) for a, b in zip(gr, gp))
            for a, b in zip(gr, gp):
                torch.testing.assert_close(a, b, rtol=G2_RTOL, atol=G2_ATOL)
            if err_lv > LEVEL_ATOL:
                raise AssertionError(f"pyramid levels differ by {err_lv} > {LEVEL_ATOL}")
            worst = max(worst, err_lv, err_g2)
            log(f"[kernel] {kind} {H}x{W} gamma={weight is not None}: "
                f"max|d levels|={err_lv:.3g} max|d g2|={err_g2:.3g}")
    # time the main path's call: uint8 640x480 frame -> 6-level pyramid
    frame = (torch.rand((480, 640), generator=g) * 255).to(torch.uint8).to(dev)
    plain_a = _cuda_ms(lambda: P.build_direct_pyramid_plain(frame.float(), 6))
    kern_a = _cuda_ms(lambda: P.build_direct_pyramid(frame, 6))
    kern_b = _cuda_ms(lambda: P.build_direct_pyramid(frame, 6))
    plain_b = _cuda_ms(lambda: P.build_direct_pyramid_plain(frame.float(), 6))
    log(f"[kernel] 480x640 uint8 6 levels, median of 50 (plain, kernel, kernel, plain): "
        f"{plain_a:.4f} {kern_a:.4f} {kern_b:.4f} {plain_b:.4f} ms")
    return worst, min(kern_a, kern_b), min(plain_a, plain_b)


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
    slam = SLAMSystem(80.0, 80.0, 63.5, 47.5, 128, 96, cfg, enable_loop_closure=False)
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
        f"reloc_unported={slam.n_reloc_unported} ATE={ate:.6f} (bar {bar:.4f}, "
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
    if slam.n_reloc_unported != 0:
        failures.append("relocalization was needed")
    if not ate <= bar:
        failures.append(f"ATE {ate} above {bar}")
    if launches != SEQ_FRAMES * cfg.pyr_levels or plain != 0:
        failures.append(f"kernel launches {launches} (want {SEQ_FRAMES * cfg.pyr_levels}), "
                        f"plain calls {plain}")
    if failures:
        raise AssertionError("main path: " + "; ".join(failures))
    return launches


def main():
    card = phase_environment()
    phase_build()
    err, ms, plain_ms = phase_kernel()
    phase_parity()
    launches = phase_main_path(card)
    log(json.dumps({"kernels": [{
        "name": "pyramid_level", "route": "cuda",
        "source": "hslam_tpu_torch/csrc/pyramid.cu",
        "replaces": "hslam_tpu/ops/pallas_kernels.py:38",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
