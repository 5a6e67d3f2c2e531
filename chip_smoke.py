"""Smoke test of the PyTorch + CUDA port (hslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure is fatal; nothing falls back to the CPU):
  1. environment: card name and power limit, torch/CUDA versions, TF32 off;
  2. build the CUDA kernels from csrc/ with nvcc, printing what ptxas says
     of each: the pyramid (the fused kernel and the per-level yardstick,
     one library) and the tracker (the scoring and the coarse-to-fine
     solve, another);
  3. the fused kernel vs its plain torch version on the card (seven shapes
     from 1x1 to 1100x1500, uint8 and float32, 1 to 8 levels, with/without a
     gamma weight), then timed for the main path's call (480x640 uint8, 6
     levels) in turns with the per-level kernel and the plain version: the
     call (CUDA events around the wrapper) and the kernels alone (spans of
     back-to-back launches, warm and with a 64 MB write before each), held
     against the memory bound; the same for the long run's call (96x128
     float32, 3 levels, phase 17); then the tracker's kernels against their
     plain versions at the benchmark cell's shapes (480x640, 6 levels, 32
     hypotheses), timed in turns with the plain route, held against the
     bytes of the passes they made;
  4. device parity: the coarse tracker and one windowed BA from the same
     state on CUDA and on the CPU;
  5. the direct-only path: SLAMSystem.process_frame on the card over 60
     frames of the 640x480 synthetic arc with bench.py's capacities, checked
     for initialization, keyframes, lost frames, ATE and kernel launches (one
     per pyramid);
  6. hybrid device parity: feature extraction, matching, the init
     refinement and PnP on one 480x640 frame, on CUDA and on the CPU;
  7. the main path: SLAMSystem's default constructor (the hybrid
     configuration, loop closure on the shipped vocabulary, the card) through
     process_frame_pipelined with the mapping thread and the loop-closure
     worker, 60 frames, checked for initialization, keyframes, valid poses,
     ATE, indirect observations in the BA, pyramid kernel launches and a live
     worker, with fps and latencies printed; then once more without loop
     closure, for what the worker costs the tracker;
  8. relocalization on the card: the kidnapped camera (pose jump plus 4x
     gain) through the sequential hybrid system;
  9. the loop-closure modules at full size: BoW quantization and scoring of a
     480x640 frame's 512 descriptors through the shipped 10^4-word
     vocabulary and a 500-node Sim3 pose graph through the dense and the
     matrix-free solver, each on CUDA and on the CPU; then a 10,000-node
     graph relaxed matrix-free on the card, under 1 GiB;
 10. the LoopCloser on the card: a drifted 20-keyframe loop at 480x640 with
     512 keypoints a frame, detected against a keyframe at least 10 back and
     corrected by the pose graph;
 11. the loop sequence: the arc, the arc again under exposure flicker, the
     flight back and the revisit (326 frames) through the sequential entry
     with loop closure on, then one large gauge correction of the window and
     at least 10 more frames, until a keyframe step has run after it;
 12. online photometric calibration (bench.py's photocal phase): 72 frames
     of the arc through an unmodelled gamma 0.7, vignette and exposure, the
     pipelined entry with the mapping thread, without and then with the
     calibrator (a fit every 8 frames), held to the JAX package's outcome;
     the fit timed, and one fit redone on the CPU;
 13. checkpoint and the metrics stream: the sequential hybrid system over
     the 60-frame arc writing its JSONL stream, saved at frame 40, restored
     bit for bit into a fresh system on the card, both run on to frame 60;
 14. distributed: the point-sharded BA and point marginalization, the
     edge-sharded PCG (10,000 nodes) and the keyframe-block-sharded global BA
     (256 keyframes) on a world of one over NCCL, bit for bit against the
     unsharded calls, then phase 7's main path with dist_mesh there (phase
     7's bars); on two ranks over Gloo on the one card, the calls against
     them within tests/test_dist.py's tolerances; then the default hybrid
     system with dist_mesh on both ranks over the arc (the same bits on both,
     ATE, keyframes against the single-process run), phase 7's main path
     (pipelined, loop closure) in lockstep on both ranks, once as it comes
     and once with rank 1's mapping thread slowed (the same bits on both,
     phase 7's bars, pyramid launches per rank, fps against phase 7, the
     control broadcasts per frame and per mapping step), and
     dryrun_multichip(2). Each rank is a spawned process; no scaling is
     claimed (one card);
 15. sequences from disk: an EuRoC (752x480 RadTan) and a TUM monoVO
     (1280x1024 FOV, response, vignette, exposures) fixture, both cropped
     to 640x480; every frame of each through the prefetching loader
     (io/native_loader) against FrameCorrector on the card; then
     tools/run_sequence through the loader (sequential: the metrics stream,
     debug PNGs, the live map over HTTP, the PLY export, the TUM trajectory
     and its ATE), once more on EuRoC with the same flags and
     --no-prefetch, and
     tools/eval_baseline (configs 2 and 3, pipelined), held to the JAX
     package's keyframes and ATE; per frame the loader's wait, or the
     inline decode, correction + remap and host round trip, and
     process_frame; then the TUM fixture through run_sequence
     --online-calib (frames remapped only, the calibrator fitting response
     and vignette), through the loader and inline: phase 12's calibration
     bars, the fit count and ms per fit, the same keyframes on both;
 16. the tools: drive_synthetic, profile_kf at 640x480 with a profiler
     trace, train_vocab on generated scenes loaded into SLAMSystem,
     make_synthetic_dataset then run_sequence on it, and loop_debug over
     phase 11's 326 frames through the pipelined entry with the
     loop-closure worker live, held to the JAX package's pipelined outcome;
 17. the long run: tests/test_longrun.py's 500-frame drift check (a slow
     sweep over tests/test_system.py's 96x128 plane under an exposure
     flicker), rendered on the card from io/synthetic's copy of the scene,
     through the sequential system with its Config and loop closure, held
     to its bars (never lost, more than 50 keyframes and loop-closure
     entries, ATE under 0.20), with fps, process_frame p50/p95 and the
     JAX package's outcome beside them.

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
# the same package over phase 11's 326-frame loop sequence, sequential entry,
# loop closure on (tests/test_torch_loop.py::test_loop_sequence_jax_reference)
JAX_CPU_LOOP = dict(keyframes=29, valid=326, ate=0.019407264043568895, loops_closed=0,
                    verified_insignificant=16)
# the same package over phase 12's 72 photocal frames, pipelined, without and
# with the online calibrator (tests/test_torch_photo_calib.py::
# test_photocal_sequence_jax_reference): ATE against the camera centres, valid
# poses, keyframes, and the calibrated run's response error against the true
# gamma 0.7 (identity: 24.49 levels RMS). The uncalibrated ATE moves with thread
# timing (0.0075 to 0.0126 over three runs); the calibrated one held 0.0083-0.0085
JAX_CPU_PHOTOCAL = dict(frames=72, ate_off=0.007532983677308477, valid_off=72, keyframes_off=12,
                        ate_on=0.008458447826464335, valid_on=72, keyframes_on=12,
                        err_est=3.4370534879746852)
# the same package over phase 15's two fixtures (io/synthetic.write_euroc and
# write_tum of DATASET_SCENE, 60 frames; sha256 of the raw frames): the
# sequential default-config system, loop closure on for EuRoC, the TUM one
# corrected then remapped (tests/test_torch_tools.py::
# test_dataset_slice_matches_jax_at_sensor_size), keyframed frames and ATE;
# and eval_baseline's pipelined configs 2 (TUM) and 3 (EuRoC), correction
# first (C17), their ATE over three reruns (test_run_config_jax_reference_
# at_sensor_size; the keyframes move with thread timing, C7); and the JAX
# script's dataset branch with --online-calib on the TUM fixture (Config(),
# frames remapped only; tests/test_torch_online_calib.py::
# test_online_calib_dataset_branch_against_the_jax_script[sensor]), with its
# fitted response's RMS error against the fixture's gamma 0.7 in levels
JAX_CPU_DATASET = {
    "euroc": dict(sha256="8e684081692b008861c6441e1eee10b2463aba3cb8fbb67726699738a429a04a",
                  kf_frames=[0, 5, 14, 35, 57], ate=0.002779311708224512),
    "tum": dict(sha256="f362a6e8c4b146f240680aa6c182981174aeb2df35c83b6bcb07d36059dbdf4c",
                kf_frames=[0, 10, 25, 34, 44, 55], ate=0.007449207950828182),
    "tum_online": dict(kf_frames=[0, 10, 23, 34, 44, 55], ate=0.007432976913404848,
                       response_err=6.1620317942291525),
    "config2": dict(ate_min=0.0075609987571244345, ate_max=0.0075609987571244345,
                    keyframes=7),
    "config3": dict(ate_min=0.0029498731546208617, ate_max=0.0029498731546208617,
                    keyframes=5),
}
# the same package over phase 16's loop_debug: io/synthetic's arc (60 frames)
# and loop sequence (326 frames in all) through the pipelined entry with the
# mapping thread and the loop-closure worker, three reruns (tests/
# test_torch_scripts.py::test_loop_debug_jax_reference; keyframes move with
# thread timing, C7): 26, 32, 34 keyframes, loops closed 2, 3, 0 and
# verified below significance 9, 9, 21; the loops that fire leave the ATE
# far above the sequential entry's (phase 11: 0.0194)
JAX_CPU_LOOP_DEBUG = dict(valid=326, ate_min=0.12712647885699854, ate_max=0.16234654687324615,
                          keyframes=(26, 34), loops_closed=(0, 3), verified_min=11)
# the same package over phase 16's make_synthetic_dataset (its defaults,
# 320x240, 60 frames, rendered on the CPU; sha256 of the frames), sequential,
# Config(), loop closure on, corrected then remapped (tests/
# test_torch_scripts.py::test_synthetic_dataset_run_sequence_jax_reference;
# the port on the CPU: [0, 9, 26, 35, 45, 59], ATE 0.0728)
JAX_CPU_SYNTH = dict(sha256="2a82e690b36f3033bd72799ce4809257e1a3b4921119421c67688f9e727b5006",
                     kf_frames=[0, 10, 27, 35, 44, 59], ate=0.07577175173288406)
# the same package over phase 17's 500 frames (tests/test_longrun.py's
# sweep, its Config, sequential, loop closure on the shipped vocabulary;
# tests/test_torch_longrun.py::test_longrun_jax_reference, which checks this
# copy): keyframes, loop-closure entries, loops closed, verified below
# significance, valid poses, ATE over every frame
LONGRUN_CFG = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
                   pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
                   desired_point_density=400.0, desired_immature_density=300.0,
                   tracker_iters_per_level=(6, 10, 10))
JAX_CPU_LONGRUN = dict(frames=500, valid=500, keyframes=84, entries=83, loops_closed=2,
                       verified_insignificant=0, ate=0.09761475765813628)
# numbers one phase hands to a later one (phase 7's fps to phase 14)
RESULTS: dict = {}
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


def _ptxas_lines(lib, names):
    """ptxas' registers, shared memory and spills of each entry function of
    a built library, by the first of `names` ((marker, name)) its mangled
    name holds."""
    from hslam_tpu_torch import _cuda
    lines = _cuda.ptxas_log[lib].splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        name = next((n for marker, n in names if marker in line), None)
        if name is not None:
            out[name] = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                                 if "Used" in x or "spill" in x)
            log(f"[build] ptxas {name}: {out[name]}")
    return out


def phase_build():
    from hslam_tpu_torch import _cuda
    from hslam_tpu_torch.ops import pyramid as P
    from hslam_tpu_torch.ops import tracker as T
    t0 = time.perf_counter()
    P._kernels()
    log(f"[build] pyramid.cu (fused + per-level entries) built+loaded in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {_cuda.build_seconds.get('pyramid', 0.0):.2f}s)")
    _ptxas_lines("pyramid", [("fused_kernelIh", "fused<uint8>"),
                             ("fused_kernelIf", "fused<float32>"),
                             ("pyramid_level", "per-level")])
    t0 = time.perf_counter()
    T._kernels()
    log(f"[build] tracker.cu (scoring + coarse-to-fine entries) built+loaded in "
        f"{time.perf_counter() - t0:.2f}s (nvcc {_cuda.build_seconds.get('tracker', 0.0):.2f}s)")
    return _ptxas_lines("tracker", [("track_score", "track_score_kernel"),
                                    ("track_coarse", "track_coarse_kernel")])


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
    # the calibrated path's input: a corrected float32 frame runs past 255
    # where 1/V > 1 (up to ~2550 under the vignette clamp) and below 1; the
    # gamma weight's index is clamped to [0, 255], truncating toward zero
    cal = torch.rand((480, 640), generator=g) * 2550.0
    cal[torch.rand((480, 640), generator=g) < 0.1] *= 1.0 / 2550.0
    cal_dev = cal.to(dev)
    lv, gr = P.build_direct_pyramid(cal_dev, 6, gw)
    lp, gp = P.build_direct_pyramid_plain(cal_dev, 6, gw)
    for a, b in zip(gr, gp):
        torch.testing.assert_close(a, b, rtol=G2_RTOL, atol=G2_ATOL * 100.0)
    err_cal = max(float((a - b).abs().max()) for a, b in zip(lv, lp))
    if not err_cal <= LEVEL_ATOL * 10.0:
        raise AssertionError(f"pyramid levels of a 0..2550 frame differ by {err_cal}")
    n_cases += 1
    log(f"[kernel] f32 480x640 in [0, 2550] (10% below 1) with gamma: max|d| levels "
        f"{err_cal:.3g} (tol {LEVEL_ATOL * 10.0:g}), g2 "
        f"{max(float((a - b).abs().max()) for a, b in zip(gr, gp)):.3g} "
        f"(rtol {G2_RTOL:g}, atol {G2_ATOL * 100.0:g}: values 10x the uint8 range)")
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

    # the calibrated path's call: a corrected float32 480x640 frame with the
    # gamma weight, 6 levels
    fcal = (torch.rand((480, 640), generator=g) * 300.0).to(dev)
    n_bytes_f = fcal.numel() * 4 + 16 * sum(h * w for h, w in lay.shapes)
    bound_f = 1e3 * n_bytes_f / H100_BYTES_PER_S
    runs_f = {"plain": lambda: P.build_direct_pyramid_plain(fcal, 6, gw),
              "fused": lambda: P.build_direct_pyramid(fcal, 6, gw)}
    call_f = [(k, _cuda_ms(runs_f[k])) for k in ("plain", "fused", "fused", "plain")]
    log("[kernel] 480x640 float32 + gamma 6 levels, call_ms, in turns: "
        + " ".join(f"{k} {t:.4f}" for k, t in call_f))

    def fused_f32():
        P.launch_pyramid(fcal, buf, 6, gw)

    for _ in range(20):
        fused_f32()
    warm_f = [_span_ms(fused_f32, 200) for _ in range(5)]
    flush_only = [_span_ms(lambda: flush.fill_(1), 200) for _ in range(5)]
    cold_f = [_span_ms(cold(fused_f32), 200) for _ in range(5)]
    dev_f = float(np.median(warm_f))
    dev_f_cold = float(np.median(cold_f)) - float(np.median(flush_only))
    share_f = bound_f / dev_f
    log(f"[kernel] float32 + gamma: device_ms {dev_f:.5f} ({' '.join(f'{t:.5f}' for t in warm_f)}), "
        f"device_ms_cold {dev_f_cold:.5f}; bound_ms {bound_f:.5f} ({n_bytes_f} B at 3.35 TB/s); "
        f"share_of_bound {share_f:.4f} warm, {bound_f / dev_f_cold:.4f} cold")
    if not 0.0 < share_f <= 1.0:
        raise AssertionError(f"float32 share_of_bound {share_f} is not in (0, 1]")
    small = _small_pyramid_case(g, buf, flush)
    tracker = _tracker_kernel_case()
    return dict(tracker=tracker,
                max_abs_err=max(worst, small.pop("max_abs_err")), ms=device_ms, call_ms=call_ms["fused"],
                device_ms=device_ms, device_ms_cold=device_ms_cold, bound_ms=bound_ms,
                bound_by="bytes", share_of_bound=share, per_level_ms=call_ms["per_level"],
                per_level_device_ms=dev_ms["per_level"][0], plain_ms=call_ms["plain"],
                library_ms=None,
                f32_gamma_call_ms=min(t for k, t in call_f if k == "fused"),
                f32_gamma_device_ms=dev_f, f32_gamma_device_ms_cold=dev_f_cold,
                f32_gamma_bound_ms=bound_f, f32_gamma_share_of_bound=share_f,
                f32_gamma_plain_ms=min(t for k, t in call_f if k == "plain"), **small)


def _small_pyramid_case(g, buf, flush):
    """The long run's call (phase 17): a float32 96x128 frame in [0, 255]
    (rendered, times the flicker gain, clipped), 3 levels, no gamma weight:
    held against the plain version, then timed as the main path's call is."""
    from hslam_tpu_torch.io import synthetic as syn
    from hslam_tpu_torch.ops import pyramid as P
    H, W, n = syn.SWEEP_H, syn.SWEEP_W, LONGRUN_CFG["pyr_levels"]
    frame = (torch.rand((H, W), generator=g) * 255.0).cuda()
    lv, gr = P.build_direct_pyramid(frame, n)
    lp, gp = P.build_direct_pyramid_plain(frame, n)
    torch.cuda.synchronize()
    for a, b in zip(gr, gp):
        torch.testing.assert_close(a, b, rtol=G2_RTOL, atol=G2_ATOL)
    err = max(float((a - b).abs().max()) for a, b in zip(lv + gr, lp + gp))
    err_lv = max(float((a - b).abs().max()) for a, b in zip(lv, lp))
    if not err_lv <= LEVEL_ATOL:
        raise AssertionError(f"96x128 pyramid levels differ by {err_lv} > {LEVEL_ATOL}")
    lay = P.pyramid_layout(H, W, n)
    n_bytes = frame.numel() * 4 + 16 * sum(h * w for h, w in lay.shapes)
    bound = 1e3 * n_bytes / H100_BYTES_PER_S
    runs = {"plain": lambda: P.build_direct_pyramid_plain(frame, n),
            "fused": lambda: P.build_direct_pyramid(frame, n)}
    call = [(k, _cuda_ms(runs[k])) for k in ("plain", "fused", "fused", "plain")]

    def fused_into():
        P.launch_pyramid(frame, buf, n)

    for _ in range(20):
        fused_into()
    warm = [_span_ms(fused_into, 200) for _ in range(5)]
    flush_only = [_span_ms(lambda: flush.fill_(1), 200) for _ in range(5)]
    cold = [_span_ms(lambda: (flush.fill_(1), fused_into()), 200) for _ in range(5)]
    dev = float(np.median(warm))
    dev_cold = float(np.median(cold)) - float(np.median(flush_only))
    log(f"[kernel] long run's call, 96x128 float32 in [0, 255], 3 levels: max|d| {err:.3g} "
        f"(levels {err_lv:.3g}, tol {LEVEL_ATOL:g}); call_ms in turns "
        + " ".join(f"{k} {t:.4f}" for k, t in call)
        + f"; device_ms {dev:.5f} ({' '.join(f'{t:.5f}' for t in warm)}), device_ms_cold "
        f"{dev_cold:.5f}; bound_ms {bound:.6f} ({n_bytes} B at 3.35 TB/s); share_of_bound "
        f"{bound / dev:.4f} warm")
    if not 0.0 < bound / dev <= 1.0:
        raise AssertionError(f"96x128 share_of_bound {bound / dev} is not in (0, 1]")
    return dict(max_abs_err=err, small_96x128_l3_call_ms=min(t for k, t in call if k == "fused"),
                small_96x128_l3_plain_ms=min(t for k, t in call if k == "plain"),
                small_96x128_l3_device_ms=dev, small_96x128_l3_device_ms_cold=dev_cold,
                small_96x128_l3_bound_ms=bound, small_96x128_l3_share_of_bound=bound / dev)


TEMPLATE_BYTES_A_POINT = 16       # a valid template point's u, v, idepth, colour (f32)
PIXEL_BYTES = 12                  # a level's [I, dx, dy] in f32


def _tracker_passes(lm, residuals, n_hyp, coarsest):
    """The residual passes a tracking call made, level by level, from its
    record: each level that ran makes one pass before its LM, one per
    cutoff doubling and iteration and a final one (a repeated level's
    second run is left out: a lower bound); the scoring makes 1 + 10 a
    hypothesis at the coarsest level."""
    passes = {lvl: (2 + int(lm[1][lvl]) + int(lm[0][lvl]) if np.isfinite(residuals[lvl]) else 0)
              for lvl in range(len(residuals))}
    passes[coarsest] += n_hyp * 11
    return passes


def _touched_pixels(tpl, lvl, img, K, R, t):
    """The distinct pixels of the level `img` whose [I, dx, dy] a pass at
    (R, t) gathers: the 2x2 cell of each valid template point that lands
    inside (ops/tracker._residual_pass's warp)."""
    u, v, idp, ok = tpl.u[lvl], tpl.v[lvl], tpl.idepth[lvl], tpl.valid[lvl]
    fx, fy, cx, cy = K.tolist()
    Hl, Wl = img.shape[0], img.shape[1]
    ray = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], 1)
    P = ray @ R.T + idp[:, None] * t
    Ku, Kv = fx * P[:, 0] / P[:, 2] + cx, fy * P[:, 1] / P[:, 2] + cy
    inside = ok & (Ku > 2) & (Kv > 2) & (Ku < Wl - 3) & (Kv < Hl - 3) & (P[:, 2] > 0)
    ix, iy = Ku[inside].floor().long(), Kv[inside].floor().long()
    cells = torch.cat([iy * Wl + ix, iy * Wl + ix + 1, (iy + 1) * Wl + ix, (iy + 1) * Wl + ix + 1])
    return int(torch.unique(cells).numel())


def _tracker_kernel_case():
    """The tracker's kernels at the benchmark cell's shapes (480x640, 6
    levels, 32 hypotheses, the template at its cap, the stated caps), held
    to the plain version on the same CUDA tensors, then timed: the call
    (scoring, argmin and coarse-to-fine solve) through the kernels and
    through the plain route, in turns, and the kernels alone. Two bounds:
    bytes, each level's template read once and the pixels its gathers
    touch at the final pose read once, at 3.35 TB/s; latency, the passes of
    the serial chain (the scoring's 11, then the coarse-to-fine passes)
    times the cost of one pass of the coarse-to-fine kernel with almost
    nothing to read (measured: its time on a template of 16 points, cut to
    its valid entries, over its passes)."""
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.io.synthetic import tracker_case
    from hslam_tpu_torch.ops import tracker as T
    c = tracker_case(device=torch.device("cuda"))
    cfg = Config()
    tpl, pyr, K = c["template"], c["target_pyr"], c["K_pyr"]
    rest = (c["aff0"], c["exp_ref"], c["exp_new"], c["aff_ref"], cfg)

    def kernel():
        return T.track_coarse_multi(tpl, pyr, K, c["R_b"], c["t_b"], *rest)

    def plain():
        scores = T.score_hypotheses_plain(tpl, pyr[5], K[5], 5, c["R_b"], c["t_b"], *rest)
        b = torch.argmin(scores).reshape(1)
        return (T.track_coarse_plain(tpl, pyr, K, c["R_b"].index_select(0, b)[0],
                                     c["t_b"].index_select(0, b)[0], *rest), b[0])

    (rk, bk), (rp, bp) = kernel(), plain()
    torch.cuda.synchronize()
    d_t = float((rk.t - rp.t).abs().max())
    d_aff = float((rk.aff - rp.aff).abs().max())
    log(f"[tracker] 480x640, 6 levels, 32 hypotheses, {[int(u.numel()) for u in tpl.u]} template "
        f"points: best {int(bk)} / plain {int(bp)}; LM iterations {rk.lm[0].tolist()} / "
        f"{rp.lm[0].tolist()}; max|dt| {d_t:.3g}, max|daff| {d_aff:.3g}; ok {bool(rk.ok)}")
    if int(bk) != int(bp) or not bool(rk.ok) or not d_t <= 1e-4 or not d_aff <= 1e-3:
        raise AssertionError("the tracker kernels differ from the plain version")
    lm, res = rk.lm.cpu().numpy(), rk.residuals.cpu().numpy()
    passes = _tracker_passes(lm, res, 0, 5)
    touched = {lvl: _touched_pixels(tpl, lvl, pyr[lvl], K[lvl], rk.R, rk.t)
               for lvl, p in passes.items() if p}
    # every entry's valid flag, a valid point's four floats, a touched pixel
    n_bytes = sum(int(tpl.u[lvl].numel()) + int(tpl.valid[lvl].sum()) * TEMPLATE_BYTES_A_POINT
                  + n * PIXEL_BYTES for lvl, n in touched.items())
    bound = 1e3 * n_bytes / H100_BYTES_PER_S
    call = []
    for k in ("plain", "kernel", "kernel", "plain"):
        fn = kernel if k == "kernel" else plain
        call.append((k, _cuda_ms(fn, reps=50 if k == "kernel" else 5,
                                 warm=5 if k == "kernel" else 1)))
    log("[tracker] call_ms, CUDA events around the call, in turns: "
        + " ".join(f"{k} {t:.4f}" for k, t in call))
    for _ in range(5):
        kernel()
    whole = [_span_ms(kernel, 25) for _ in range(5)]
    def score_only():
        T.score_hypotheses(tpl, pyr[5], K[5], 5, c["R_b"], c["t_b"], *rest)

    score = [_span_ms(score_only, 100) for _ in range(5)]
    r0 = c["R_b"].index_select(0, bk.reshape(1))[0]
    t0 = c["t_b"].index_select(0, bk.reshape(1))[0]
    coarse = [_span_ms(lambda: T.track_coarse(tpl, pyr, K, r0, t0, *rest), 100) for _ in range(5)]
    dev_ms, score_ms, coarse_ms = (float(np.median(x)) for x in (whole, score, coarse))
    # the latency floor of a pass: the coarse-to-fine kernel on 16 points
    # (build_template puts the valid entries first)
    e = tracker_case(device=torch.device("cuda"), n_points=16)
    nv = [int(x.sum()) for x in e["template"].valid]
    e_tpl = e["template"]._replace(**{f: [x[:n] for x, n in zip(getattr(e["template"], f), nv)]
                                      for f in e["template"]._fields})
    e_args = (e_tpl, e["target_pyr"], e["K_pyr"], e["R_b"][0], e["t_b"][0], e["aff0"],
              e["exp_ref"], e["exp_new"], e["aff_ref"], cfg)
    er = T.track_coarse(*e_args)
    e_passes = sum(_tracker_passes(er.lm.cpu().numpy(), er.residuals.cpu().numpy(), 0, 5).values())
    e_ms = float(np.median([_span_ms(lambda: T.track_coarse(*e_args), 100) for _ in range(5)]))
    pass_us = 1e3 * e_ms / max(e_passes, 1)
    chain = T.SCORE_ITERS + 1 + sum(passes.values())
    latency_ms = 1e-3 * chain * pass_us
    share = bound / dev_ms
    log(f"[tracker] device_ms {dev_ms:.5f} ({' '.join(f'{t:.5f}' for t in whole)}): scoring "
        f"{score_ms:.5f}, coarse-to-fine {coarse_ms:.5f}; coarse-to-fine passes by level "
        f"{passes}, pixels touched {touched}; bytes bound_ms {bound:.6f} ({n_bytes} B at 3.35 "
        f"TB/s), share_of_bound {share:.4f}; latency bound_ms {latency_ms:.5f} ({chain} serial "
        f"passes x {pass_us:.4f} us, a pass on 16 points: {e_ms:.5f} ms over {e_passes} passes), "
        f"share_of_latency_bound {latency_ms / dev_ms:.4f}")
    if not 0.0 < share <= 1.0:
        raise AssertionError(f"tracker share_of_bound {share} is not in (0, 1]")
    return dict(call_ms=min(t for k, t in call if k == "kernel"),
                plain_ms=min(t for k, t in call if k == "plain"), device_ms=dev_ms,
                score_device_ms=score_ms, coarse_device_ms=coarse_ms, bound_ms=bound,
                bound_by="bytes", share_of_bound=share, latency_bound_ms=latency_ms,
                share_of_latency_bound=latency_ms / dev_ms, serial_passes=chain,
                pass_floor_us=pass_us, library_ms=None,
                lm_iters=int(lm[0].sum()), max_abs_err=max(d_t, d_aff))


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
    from hslam_tpu_torch.ops import tracker as T
    from hslam_tpu_torch.utils import trace
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
    T.kernel_launches = 0
    T.plain_calls = 0
    trace.enable()          # its counter track_kernel: the coarse-to-fine launches
    frame_ms, kf_ms = [], []
    tracked = 0             # calls that track (the system was initialized before them)
    t_all = time.perf_counter()
    for i, f in enumerate(frames):
        tracked += slam.initialized
        t0 = time.perf_counter()
        shell = slam.process_frame(f, 0.05 * i)
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t0)
        if slam.initialized and shell.tracking_ref is not None:
            (kf_ms if shell.is_kf else frame_ms).append(dt)
    wall = time.perf_counter() - t_all
    trace.disable()
    launches, plain = P.kernel_launches, P.plain_calls
    # each tracked frame: one scoring and one coarse-to-fine launch, then one
    # coarse-to-fine launch a serial try if the batched winner was rejected
    t_launches, t_plain = T.kernel_launches, T.plain_calls
    serial = trace.snapshot()["counters"].get("track_kernel", 0) - tracked
    RESULTS["track_main"] = dict(launches=t_launches, plain=t_plain, frames=tracked)

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
    log(f"[main] pyramid kernel launches {launches} plain calls {plain}; tracker kernel "
        f"launches {t_launches} (2 x {tracked} tracked frames + {serial} serial tries) plain "
        f"calls {t_plain}; max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
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
    if tracked < 1 or serial < 0 or t_launches != 2 * tracked + serial or t_plain != 0:
        failures.append(f"tracker kernel launches {t_launches} (want 2 x {tracked} + {serial}), "
                        f"plain calls {t_plain}")
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


def _run_pipelined(card, loop_closure):
    """60 frames of the arc through the pipelined entry; with `loop_closure`
    the system is built by its default constructor arguments."""
    from hslam_tpu_torch.io.synthetic import Scene, make_sequence
    from hslam_tpu_torch.io.trajectory import ate_rmse
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    from hslam_tpu_torch.ops import tracker as T
    H, W, FX = 480, 640, 320.0
    cfg = _hybrid_cfg()
    frames, centres = make_sequence(Scene(H, W, FX), SEQ_FRAMES)
    args = (FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, cfg)
    if loop_closure:
        # loop closure, the shipped vocabulary and the card: all defaults
        slam = SLAMSystem(*args, sequential=False)
    else:
        slam = SLAMSystem(*args, sequential=False, enable_loop_closure=False)
    tag = "[pipelined]" if loop_closure else "[pipelined, no loop closure]"
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        P.kernel_launches = 0
        P.plain_calls = 0
        T.kernel_launches = 0
        T.plain_calls = 0
        done_ms = []
        tracked = 0         # calls that run track_step (initialized before them)
        t_all = time.perf_counter()
        for i, f in enumerate(frames):
            tracked += slam.initialized
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
        t_launches, t_plain = T.kernel_launches, T.plain_calls
    finally:
        slam.close()
    valid = [s.id for s in slam.shells if s.pose_valid]
    finite = all(np.all(np.isfinite(s.cam_to_world)) for s in slam.shells)
    ate = ate_rmse(centres[valid], np.array([slam.shells[i].cam_to_world[:3, 3] for i in valid]))
    bar = max(1.5 * JAX_CPU_ATE_HYBRID, 0.02)
    builds = SEQ_FRAMES + slam.n_track_retries
    # track_step: one scoring and one coarse-to-fine launch, again on a retry
    t_want = 2 * (tracked + slam.n_track_retries)
    main = RESULTS.setdefault("track_main", dict(launches=0, plain=0, frames=0))
    main.update(launches=main["launches"] + t_launches, plain=main["plain"] + t_plain,
                frames=main["frames"] + tracked)
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else float("nan")  # noqa: E731
    ms = lambda xs: [round(1e3 * x, 1) for x in xs]  # noqa: E731
    fps, p50 = SEQ_FRAMES / wall, pct(done_ms, 50)
    log(f"{tag} {card} | frames {SEQ_FRAMES} wall {wall:.2f}s fps {fps:.2f}")
    log(f"{tag} per-frame completion ms p50 {p50:.2f} "
        f"p95 {pct(done_ms, 95):.2f} (n={len(done_ms)})")
    log(f"{tag} kf_full_latencies ms {ms(slam.kf_full_latencies)}")
    log(f"{tag} initialized={slam.initialized} keyframes={slam.next_kf_id} "
        f"(JAX CPU {JAX_CPU_KFS_HYBRID}) lost={slam.is_lost} "
        f"pose_valid={len(valid)}/{SEQ_FRAMES} ATE={ate:.6f} (bar {bar:.4f}, "
        f"JAX CPU {JAX_CPU_ATE_HYBRID:.6f}) ind_obs_history={slam.ind_obs_history}")
    log(f"{tag} n_track_retries={slam.n_track_retries} "
        f"n_frames_skipped={slam.n_frames_skipped} n_relocs={slam.n_relocs} "
        f"pyramid kernel launches {launches} (builds {builds}) plain calls {plain}; tracker "
        f"kernel launches {t_launches} (2 x ({tracked} tracked + retries)) plain calls {t_plain}; "
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
    if tracked < 1 or t_launches != t_want or t_plain != 0:
        failures.append(f"tracker kernel launches {t_launches} (want {t_want}), "
                        f"plain calls {t_plain}")
    if loop_closure:
        lc = slam.loop_closer
        entries = -1 if lc is None else len(lc.entries)
        log(f"{tag} loop closer: device {slam.device.type}, vocabulary "
            f"{None if lc is None else lc.vocab.n_words} words, entries {entries} "
            f"(keyframes {slam.next_kf_id}), detect ms {[round(x, 1) for x in slam.lc_detect_ms]}, "
            f"loops closed {slam.n_loops_closed}")
        # finish() and close() raised nothing: the worker left no exception
        if lc is None or lc.vocab.n_words != 10_000 or lc.device.type != "cuda":
            failures.append("the default constructor built no loop closer on the card")
        elif entries < slam.next_kf_id - 1:
            failures.append(f"loop-closure worker saw {entries} of {slam.next_kf_id} keyframes")
    elif slam.loop_closer is not None:
        failures.append("loop closer built although disabled")
    if failures:
        raise AssertionError(f"{tag} main path: " + "; ".join(failures))
    return launches, fps, p50


def phase_pipelined(card):
    """The main path, by the default constructor; then the same run without
    loop closure, in the same call, for the worker's cost to the tracker."""
    launches, fps_on, p50_on = _run_pipelined(card, True)
    RESULTS["pipelined_fps"] = fps_on            # phase 14 (b) compares with it
    more, fps_off, p50_off = _run_pipelined(card, False)
    log(f"[pipelined] {card} | loop-closure worker on: fps {fps_on:.2f} completion p50 "
        f"{p50_on:.2f} ms; off: fps {fps_off:.2f} completion p50 {p50_off:.2f} ms")
    return launches + more


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


def _circle_graph(N, scale_drift=1.0002, noise=0.01, seed=0, loop_w=50.0):
    """The Strasdat-style fixture of tests/test_loop.py in numpy: drifted
    Sim3 odometry around a circle (per-step multiplicative scale drift + SE3
    noise), sequential edges measured from the drifted estimates, one
    ground-truth loop edge with scale 1 between the last and the first node.
    Returns the arguments of make_graph."""
    from hslam_tpu_torch.io.synthetic import se3_exp_np
    rng = np.random.RandomState(seed)
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    c, sn, z, o = np.cos(ang), np.sin(ang), np.zeros(N), np.ones(N)
    R_gt = np.stack([np.stack([c, -sn, z], -1), np.stack([sn, c, z], -1),
                     np.stack([z, z, o], -1)], 1)
    t_gt = np.stack([3 * c, 3 * sn, z], 1)
    nR = np.stack([se3_exp_np(np.r_[np.zeros(3), w])[0] for w in rng.randn(N, 3) * noise])
    nt = rng.randn(N, 3) * noise * 0.5
    s_est, R_est, t_est = np.empty(N), np.empty((N, 3, 3)), np.empty((N, 3))
    s_est[0], R_est[0], t_est[0] = 1.0, R_gt[0], t_gt[0]
    for i in range(1, N):
        Rrel = R_gt[i] @ R_gt[i - 1].T
        trel = t_gt[i] - Rrel @ t_gt[i - 1]
        Rr = nR[i] @ Rrel
        tr = scale_drift * (nR[i] @ trel) + nt[i]
        s_est[i] = s_est[i - 1] * scale_drift
        R_est[i] = Rr @ R_est[i - 1]
        t_est[i] = scale_drift * (Rr @ t_est[i - 1]) + tr
    s_est, R_est, t_est = (x.astype(np.float32).astype(np.float64) for x in (s_est, R_est, t_est))
    # S_i * S_{i-1}^-1 of the (float32) estimates, and the true loop edge
    si, sj = s_est[1:], s_est[:-1]
    Rij = R_est[1:] @ R_est[:-1].transpose(0, 2, 1)
    sij = si / sj
    tij = t_est[1:] - sij[:, None] * np.einsum("nij,nj->ni", Rij, t_est[:-1])
    Rl = R_gt[N - 1] @ R_gt[0].T
    tl = t_gt[N - 1] - Rl @ t_gt[0]
    idx = np.arange(1, N)
    return (s_est, R_est, t_est, np.ones(N, bool), np.r_[idx, N - 1], np.r_[idx - 1, 0],
            (np.r_[sij, 1.0], np.concatenate([Rij, Rl[None]]), np.concatenate([tij, tl[None]])),
            np.r_[np.ones(N - 1), loop_w])


def _chi2(pg, sol):
    from hslam_tpu_torch.models import pose_graph as PG
    g = pg._replace(s=sol[0], R=sol[1], t=sol[2])
    r = PG.residuals(g, torch.zeros((g.s.shape[0], 7), device=g.t.device))
    return float(torch.sum(pg.weight[:, None] * r * r))


def _sim3_gap(a, b):
    """max |log(A_i * B_i^-1)| over the nodes of two solutions."""
    from hslam_tpu_torch.utils import lie
    a, b = ([x.detach().cpu() for x in s] for s in (a, b))
    return float(lie.sim3_log(*lie.sim3_mul(*a, *lie.sim3_inverse(*b))).abs().max())


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def phase_loop_modules(card):
    """BoW and the pose graph at full size, on CUDA and on the CPU; the
    10,000-node relaxation on the card."""
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.models import kf_step as KS
    from hslam_tpu_torch.models import pose_graph as PG
    from hslam_tpu_torch.models.system import default_vocab_path
    from hslam_tpu_torch.ops import bow
    cfg = Config()
    a, b, _, _, _ = _frame_pair()
    res = {}
    for name in ("cpu", "cuda"):
        dev = torch.device(name)
        voc = bow.load_vocabulary(default_vocab_path(), device=dev)
        # the CPU's descriptors on both devices: quantization is integer work
        if name == "cpu":
            ext = [KS.extract_feats(torch.from_numpy(x), cfg) for x in (a, b)]
        words, vecs = [], []
        for e in ext:
            w = bow.quantize(voc, e[4].to(dev), e[5].to(dev))
            words.append(w)
            vecs.append(bow.bow_vector(w, voc.n_words, idf=voc.idf))
        score = bow.l1_score(vecs[0], torch.stack(vecs))
        res[name] = [x.cpu().numpy() for x in (*words, *vecs, score)]
    c, g = res["cpu"], res["cuda"]
    n_desc, n_valid = ext[0][4].shape[0], int(ext[0][5].sum())
    words_equal = all((x == y).all() for x, y in zip(c[:2], g[:2]))
    e_vec, e_score = max(_max_err(c[2], g[2]), _max_err(c[3], g[3])), _max_err(c[4], g[4])
    log(f"[loop modules] shipped vocabulary {voc.n_words} words (k={voc.k}, levels={voc.levels}); "
        f"{n_desc} descriptors ({n_valid} valid) of a 480x640 frame: words equal on CPU and "
        f"CUDA={words_equal}, max|cpu-cuda| vector {e_vec:.3g} score {e_score:.3g} (tol 1e-6), "
        f"score(a, [a, b]) = {g[4].round(4).tolist()}")
    if n_desc != 512 or not words_equal or not (e_vec <= 1e-6 and e_score <= 1e-6):
        raise AssertionError("BoW differs between CPU and CUDA")
    if not (abs(g[4][0] - 1.0) < 1e-5 and 0.0 < g[4][1] < 1.0):
        raise AssertionError(f"BoW scores {g[4]} are not (1, in (0, 1))")
    # timing on the card: one keyframe's quantization + vector, and one query
    # against a 256-keyframe database
    d, val = ext[0][4].cuda(), ext[0][5].cuda()
    db = torch.rand((256, voc.n_words), device="cuda")
    q_ms = _cuda_ms(lambda: bow.bow_vector(bow.quantize(voc, d, val), voc.n_words, idf=voc.idf))
    s_ms = _cuda_ms(lambda: bow.l1_score(db[0], db))
    log(f"[loop modules] {card} | quantize + bow_vector of 512 descriptors {q_ms:.3f} ms; "
        f"l1_score against 256 keyframes {s_ms:.3f} ms (CUDA events, median of 50)")

    # a 500-node Sim3 circle: dense GN and PCG, on both devices
    args = _circle_graph(500)
    sols, chis = {}, {}
    for name in ("cpu", "cuda"):
        pg = PG.make_graph(*args, device=name)
        c0 = _chi2(pg, (pg.s, pg.R, pg.t))
        t0 = time.perf_counter()
        sols[name, "dense"] = PG.optimize_pose_graph(pg, n_iters=10)
        t1 = time.perf_counter()
        st = {}
        sols[name, "pcg"] = PG.optimize_pose_graph_pcg(pg, n_iters=10, cg_iters=2000, stats=st)
        float(sols[name, "pcg"][2].sum())
        t2 = time.perf_counter()
        chis[name] = (c0, _chi2(pg, sols[name, "dense"]), _chi2(pg, sols[name, "pcg"]))
        log(f"[loop modules] 500 nodes on {name}: chi2 {c0:.4g} -> dense {chis[name][1]:.4g} "
            f"({t1 - t0:.2f} s), pcg {chis[name][2]:.4g} ({t2 - t1:.2f} s, "
            f"{st['cg_iterations']} CG iterations, {st['host_syncs']} host syncs)")
    gaps = {"dense cpu-cuda": _sim3_gap(sols["cpu", "dense"], sols["cuda", "dense"]),
            "pcg cpu-cuda": _sim3_gap(sols["cpu", "pcg"], sols["cuda", "pcg"])}
    # the two solvers stop at different points of the same valley (the CG
    # ends at |r|^2 <= 1e-8): reported, and held by the chi^2 gate below
    between = _sim3_gap(sols["cuda", "dense"], sols["cuda", "pcg"])
    log("[loop modules] 500 nodes, max |sim3 log| between devices: " + ", ".join(
        f"{k} {v:.3g}" for k, v in gaps.items()) + f" (tol 5e-3); dense against pcg on "
        f"the card {between:.3g}")
    if not all(v <= 5e-3 for v in gaps.values()):
        raise AssertionError(f"pose-graph solutions differ: {gaps}")
    if not all(x < 1e-2 * c0 for c0, *rest in chis.values() for x in rest):
        raise AssertionError(f"pose graph did not relax: {chis}")
    # what LoopCloser.correct pays on the dense path, by keyframe count
    dense_ms = {}
    for n in (64, 128, 256, 512):
        pg = PG.make_graph(*_circle_graph(n), device="cuda")
        PG.optimize_pose_graph(pg, n_iters=1)
        dense_ms[n] = _timed(lambda: PG.optimize_pose_graph(pg, n_iters=8))[1]
    log(f"[loop modules] {card} | dense GN, 8 iterations, ms by nodes: "
        + " ".join(f"{n}: {t:.1f}" for n, t in dense_ms.items()))
    # one iteration at 512 nodes by part: the per-edge blocks (forward-mode
    # AD, host-bound), their placement into J, J^T J, and the solve
    J = PG.dense_jacobian(pg)
    parts = {"edge_jacobians": _timed(lambda: PG.edge_jacobians(pg))[1],
             "dense_jacobian": _timed(lambda: PG.dense_jacobian(pg))[1],
             "J^T J": _timed(lambda: J.T @ J)[1]}
    H7 = J.T @ J + torch.eye(J.shape[1], device="cuda")
    parts["solve"] = _timed(lambda: torch.linalg.solve(H7, J.T @ J[:, 0]))[1]
    log(f"[loop modules] {card} | one dense GN iteration at 512 nodes, ms by part: "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
        + f" (J {tuple(J.shape)}, {J.numel() * 4 / 2**20:.0f} MiB)")

    # 10,000 keyframes with 1.65x accumulated scale drift, matrix-free on the
    # card (the dense Hessian would be 70,000^2 floats, 19 GB)
    args = _circle_graph(10_000, scale_drift=1.00005, noise=0.002)
    pg = PG.make_graph(*args, device="cuda")
    c0 = _chi2(pg, (pg.s, pg.R, pg.t))
    if not float(pg.s[-1]) > 1.5:
        raise AssertionError("the 10,000-node fixture has no scale drift")
    PG.optimize_pose_graph_pcg(pg, n_iters=1, cg_iters=2)          # warm-up
    runs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        st = {}
        sol, ms = _timed(lambda: PG.optimize_pose_graph_pcg(pg, n_iters=5, cg_iters=1000,
                                                             stats=st))
        runs.append((sol, ms, st, torch.cuda.max_memory_allocated() / 2**20))
    sol, ms, st, mib = runs[0]
    c1 = _chi2(pg, sol)
    finite = all(bool(torch.isfinite(x).all()) for x in sol)
    same = all(torch.equal(x, y) for x, y in zip(runs[0][0], runs[1][0]))
    log(f"[loop modules] {card} | 10,000 nodes, PCG 5 GN x <=1000 CG on the card: chi2 "
        f"{c0:.5g} -> {c1:.5g} (ratio {c1 / c0:.3g}, bar 1e-3), finite={finite}, "
        f"{ms / 1e3:.2f} s ({runs[1][1] / 1e3:.2f} s again), {st['cg_iterations']} CG "
        f"iterations, {st['host_syncs']} host syncs ({ms / max(st['host_syncs'], 1):.3f} ms "
        f"per CG iteration with its sync), max_memory_allocated {mib:.1f} MiB (bar 1024); "
        f"two runs give the same bits (fixed-order sums): {same}")
    if not (c1 < 1e-3 * c0 and finite and mib < 1024.0 and same):
        raise AssertionError("the 10,000-node relaxation failed its bars")


def _se3(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def phase_loop_closer(card):
    """tests/test_loop.py's drifted loop at 480x640: 20 keyframes out along
    +x and back, the last pose equal to the first, a constant bias per step
    in the estimates; the stored features of a keyframe (512 keypoints over
    4 scales) with analytic depths; the shipped vocabulary."""
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.io.synthetic import Scene, se3_exp_np
    from hslam_tpu_torch.models import kf_step as KS
    from hslam_tpu_torch.models.loop_closure import LoopCloser
    from hslam_tpu_torch.models.system import default_vocab_path
    from hslam_tpu_torch.ops import bow
    H, W, FX, n_kf = 480, 640, 320.0, 20
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    K = np.array([[FX, 0, cx], [0, FX, cy], [0, 0, 1.0]])
    sc = Scene(H, W, FX)
    cfg = Config()
    gt = [_se3(*se3_exp_np(np.array([0.35 * np.sin(a), 0.12 * (1 - np.cos(a)), 0, 0, 0, 0])))
          for a in 2 * np.pi * np.arange(n_kf) / n_kf]
    drift = _se3(*se3_exp_np(np.array([0.01, -0.006, 0.004, 0.002, 0.003, -0.002])))
    est = [np.eye(4)]
    for i in range(1, n_kf):
        est.append(drift @ gt[i] @ np.linalg.inv(gt[i - 1]) @ est[-1])
    closer = LoopCloser(bow.load_vocabulary(default_vocab_path()), min_gap=10)
    if closer.device.type != "cuda":
        raise AssertionError("load_vocabulary did not default to the card")
    add_ms = []
    for i, T in enumerate(gt):
        img = torch.from_numpy(np.round(sc.render(T[:3, :3], T[:3, 3])).astype(np.float32)).cuda()
        u, v, _, _, desc, valid = KS.extract_feats(img, cfg)
        # analytic keypoint depths: rays hitting the plane z_world = depth
        c2w = np.linalg.inv(T)
        un, vn = u.cpu().numpy(), v.cpu().numpy()
        dirs = np.stack([(un - cx) / FX, (vn - cy) / FX, np.ones_like(un)], -1)
        zc = (sc.depth - c2w[2, 3]) / np.maximum(dirs @ c2w[2, :3], 1e-6)
        _, ms = _timed(lambda: closer.add_keyframe(
            i, i, desc, u, v, valid, np.linalg.inv(est[i]),
            kp_idepth=(1.0 / np.maximum(zc, 1e-3)).astype(np.float32), kp_depth_ok=valid))
        add_ms.append(ms)

    def gap():
        rel = np.linalg.inv(closer.entries[-1].cam_to_world) @ closer.entries[0].cam_to_world
        err = rel @ np.linalg.inv(gt[-1] @ np.linalg.inv(gt[0]))
        ang = np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1))
        return float(np.hypot(np.linalg.norm(err[:3, 3]), ang))

    g0 = gap()
    loop, det_ms = _timed(lambda: closer.detect(n_kf - 1, K))
    if loop is None:
        raise AssertionError("LoopCloser: no loop detected on the revisit")
    out, cor_ms = _timed(lambda: closer.correct(loop, fix_scale=True))
    g1 = gap()
    log(f"[loop closer] {card} | 20 keyframes, {int(valid.sum())} keypoints in the last: "
        f"add_keyframe ms p50 {np.median(add_ms[1:]):.1f}; detect {det_ms:.1f} ms -> kf "
        f"{loop.query_kf} against kf {loop.match_kf}, {loop.n_inliers} PnP inliers; correct "
        f"(dense, 20 nodes) {cor_ms:.1f} ms, {len(out)} poses; gap to the truth "
        f"{g0:.4f} -> {g1:.4f} (ratio {g1 / g0:.3f}, bar 0.6)")
    if abs(loop.match_kf - loop.query_kf) < 10 or len(out) != n_kf or not g1 < 0.6 * g0:
        raise AssertionError("LoopCloser on the card failed its bars")


def phase_loop_sequence(card):
    """The loop sequence through the sequential entry, loop closure inline
    (a deterministic cadence; the pipelined run's depends on timing), held
    to the JAX package's outcome on the same frames; then one large gauge
    correction through _apply_loop_correction and 10 more frames."""
    from hslam_tpu_torch.io.synthetic import (LOOP_REV, Scene, arc_xi, make_loop_frames,
                                             make_sequence, se3_exp_np)
    from hslam_tpu_torch.io.trajectory import ate_rmse
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    H, W, FX = 480, 640, 320.0
    scene = Scene(H, W, FX)
    frames, centres = make_sequence(scene, SEQ_FRAMES)
    lf, lc, stamps = make_loop_frames(scene, SEQ_FRAMES)
    frames, centres = frames + lf, np.concatenate([centres, lc])
    stamps = [0.05 * i for i in range(SEQ_FRAMES)] + stamps
    n = len(frames)
    slam = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, _hybrid_cfg())
    torch.cuda.synchronize()
    P.kernel_launches = 0
    P.plain_calls = 0
    t0 = time.perf_counter()
    for f, ts in zip(frames, stamps):
        slam.process_frame(f, ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def ate_of(ids, cen):
        return ate_rmse(cen[ids], np.array([slam.shells[i].cam_to_world[:3, 3] for i in ids]))

    valid = [s.id for s in slam.shells if s.pose_valid]
    finite = all(np.all(np.isfinite(s.cam_to_world)) for s in slam.shells)
    ate = ate_of(valid, centres)
    ref = JAX_CPU_LOOP
    bar = max(1.5 * ref["ate"], 0.02)
    lcl = slam.loop_closer
    verified = slam.n_loops_closed + lcl.n_verified_insignificant
    ref_verified = ref["loops_closed"] + ref["verified_insignificant"]
    det = sorted(slam.lc_detect_ms)
    log(f"[loop sequence] {card} | {n} frames sequential in {wall:.2f}s (fps {n / wall:.2f}); "
        f"keyframes {slam.next_kf_id} (JAX CPU {ref['keyframes']}), pose_valid {len(valid)}/{n} "
        f"(JAX CPU {ref['valid']}), lost={slam.is_lost}, relocs {slam.n_relocs}, full-trajectory "
        f"ATE {ate:.6f} (bar {bar:.4f}, JAX CPU {ref['ate']:.6f})")
    log(f"[loop sequence] loops closed {slam.n_loops_closed} + verified below significance "
        f"{lcl.n_verified_insignificant} (JAX CPU {ref['loops_closed']} + "
        f"{ref['verified_insignificant']}); entries {len(lcl.entries)}; detect ms p50 "
        f"{det[len(det) // 2]:.1f} max {det[-1]:.1f}; connectivity pairs {len(slam.connectivity)}")
    log(f"[loop sequence] keyframes at frames {[s.id for s in slam.shells if s.is_kf]}")
    failures = []
    if not slam.initialized or slam.is_lost or not finite:
        failures.append("not initialized, lost or non-finite poses")
    if len(valid) < ref["valid"]:
        failures.append(f"{len(valid)} valid poses (JAX CPU {ref['valid']})")
    # under the flicker a keyframe falls where the brightness term crosses
    # its threshold, and every later one follows from it: the count is not
    # stable to rounding (the same code gave 24 to 35 in six runs on one
    # H100, 26 on a CPU; float atomics order the sums differently), so it is
    # held to half of the JAX package's, not to +-1 as the 60-frame arc is
    if abs(slam.next_kf_id - ref["keyframes"]) > ref["keyframes"] / 2:
        failures.append(f"{slam.next_kf_id} keyframes (JAX CPU {ref['keyframes']})")
    if not ate <= bar:
        failures.append(f"ATE {ate} above {bar}")
    if ref_verified >= 1 and verified < 1:
        failures.append("no revisit verified, the JAX package verifies one")
    if len(lcl.entries) != slam.next_kf_id - 1:
        failures.append(f"{len(lcl.entries)} entries for {slam.next_kf_id} keyframes")
    if P.kernel_launches != n or P.plain_calls != 0:
        failures.append(f"kernel launches {P.kernel_launches} (want {n}), plain {P.plain_calls}")
    if failures:
        raise AssertionError("loop sequence: " + "; ".join(failures))

    # one large gauge correction (25 degrees, |t| ~ 1) of every keyframe, as
    # LoopCloser.correct would hand it over (its database moved too, or the
    # next keyframe would see the whole correction as drift against its
    # candidates), then the arc goes on
    G = _se3(*se3_exp_np(np.array([0.8, -0.5, 0.3, 0.25, -0.3, 0.2])))
    corr = {s.id: G @ s.cam_to_world for s in slam.shells if s.is_kf}
    for e in lcl.entries:
        e.cam_to_world = corr[e.shell_id]
    closed_before, kfs_before = slam.n_loops_closed, slam.next_kf_id
    slam._apply_loop_correction(corr)
    # at least 10 frames, and on until a keyframe step (a BA, a loop query)
    # has run in the corrected gauge; 40 frames at most
    more = []
    while len(more) < 10 or (slam.next_kf_id == kfs_before and len(more) < 40):
        R, t = se3_exp_np(arc_xi(0.05 * (LOOP_REV + len(more))))
        more.append((R, t))
        img = np.clip(np.round(scene.render(R, t)), 0, 255).astype(np.uint8)
        slam.process_frame(img, stamps[-1] + 0.05 * len(more))
    torch.cuda.synchronize()
    tail = slam.shells[-len(more):]
    cen = np.concatenate([centres, np.stack([-R.T @ t for R, t in more])])
    # frames from before the initialization have no pose to move with the map
    ids = [s.id for s in slam.shells if s.pose_valid and (s.tracking_ref is not None or s.is_kf)]
    ate2 = ate_of(ids, cen)
    state_max = float(slam.window.frames.state.abs().max())
    ok = (not slam.is_lost and all(s.pose_valid and np.all(np.isfinite(s.cam_to_world))
                                   for s in tail) and np.isfinite(state_max))
    log(f"[loop sequence] after a 25 degree, |t| 1.0 gauge correction: {len(more)} more frames, "
        f"lost={slam.is_lost}, valid={sum(s.pose_valid for s in tail)}/{len(more)}, keyframes "
        f"{slam.next_kf_id} ({kfs_before} before), max |window state| {state_max:.4g}, ATE over the {len(ids)} frames "
        f"that have a pose {ate2:.6f} (bar {bar:.4f}), loops closed since "
        f"{slam.n_loops_closed - closed_before}, pyramid launches {P.kernel_launches} plain "
        f"{P.plain_calls}")
    # a common transform of every pose leaves the aligned ATE where it was
    if (not ok or not ate2 <= bar or slam.next_kf_id == kfs_before
            or P.kernel_launches != n + len(more) or P.plain_calls != 0):
        raise AssertionError("loop sequence: tracking after the gauge correction failed")
    return P.kernel_launches


PHOTOCAL_FRAMES = 72


def _photocal_run(card, frames, exps, centres, enable):
    """One run of phase 12: the pipelined entry with the mapping thread,
    bench.py's capacities, with or without the online calibrator. Each fit's
    inputs are kept (not timed here: no sync enters the run)."""
    from hslam_tpu_torch.io.trajectory import ate_rmse
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    H, W, FX = 480, 640, 320.0
    slam = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, _hybrid_cfg(), sequential=False,
                      online_photo_calib=enable, photo_calib_every=8, enable_loop_closure=False)
    fits = []
    real_fit = slam._pc_fit

    def recording_fit(*args, **kw):
        out = real_fit(*args, **kw)
        fits.append((args, kw, out))
        return out

    slam._pc_fit = recording_fit
    tag = "[photocal on]" if enable else "[photocal off]"
    try:
        torch.cuda.synchronize()
        P.kernel_launches = 0
        P.plain_calls = 0
        done_ms = []
        n_cal = 0          # frames dispatched with the correction on (float32 + gamma)
        t_all = time.perf_counter()
        for i, f in enumerate(frames):
            t0 = time.perf_counter()
            n_cal += slam._pc_luts is not None
            out = slam.process_frame_pipelined(f, 0.05 * i, exposure=exps[i])
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
    n = len(frames)
    p50 = float(np.percentile(done_ms, 50))
    log(f"{tag} {card} | frames {n} wall {wall:.2f}s fps {n / wall:.2f} completion ms p50 "
        f"{p50:.2f} p95 {float(np.percentile(done_ms, 95)):.2f}; initialized={slam.initialized} "
        f"keyframes={slam.next_kf_id} pose_valid={len(valid)}/{n} lost={slam.is_lost} "
        f"retries={slam.n_track_retries} relocs={slam.n_relocs} ATE={ate:.6f}; pyramid launches "
        f"{launches} (builds {n + slam.n_track_retries}; {n_cal} frames float32 + gamma) plain "
        f"calls {plain}")
    if not slam.initialized or slam.is_lost or not finite:
        raise AssertionError(f"{tag}: not initialized, lost or non-finite poses")
    if launches != n + slam.n_track_retries or plain != 0 or (enable and n_cal == 0):
        raise AssertionError(f"{tag}: pyramid launches {launches} (want one per pyramid, "
                             f"{n + slam.n_track_retries}), plain calls {plain}, "
                             f"{n_cal} calibrated")
    return dict(slam=slam, fits=fits, fit=real_fit, ate=ate, valid=len(valid), fps=n / wall,
                p50=p50, launches=launches)


def phase_photocal(card):
    """bench.py's photocal phase on the port: without, then with the online
    calibrator, in one call; the calibrated run held to the JAX package's."""
    from hslam_tpu_torch.io.synthetic import Scene, make_photocal_frames
    from hslam_tpu_torch.models import photo_calib as PC
    from hslam_tpu_torch.ops.undistort import photometric_correct
    frames, exps, centres = make_photocal_frames(Scene(480, 640, 320.0), PHOTOCAL_FRAMES)
    off = _photocal_run(card, frames, exps, centres, False)
    on = _photocal_run(card, frames, exps, centres, True)
    slam, ref = on["slam"], JAX_CPU_PHOTOCAL
    rms = float(slam._pc_rms) if slam._pc_rms is not None else float("nan")
    lut = PC.gamma_lut(slam._pc_params).cpu().numpy().astype(np.float64)
    x = np.arange(256.0)
    truth = 255.0 * (x / 255.0) ** 0.7
    err_est = float(np.sqrt(np.mean((lut - truth) ** 2)))
    err_id = float(np.sqrt(np.mean((x - truth) ** 2)))
    vm = PC.vignette_map(slam._pc_params, 480, 640).cpu().numpy()
    bar = max(1.5 * ref["ate_on"], 0.02)
    log(f"[photocal] {card} | ATE without {off['ate']:.6f} with {on['ate']:.6f} (bar {bar:.4f}; "
        f"JAX CPU {ref['ate_off']:.6f} / {ref['ate_on']:.6f}); valid {off['valid']} / "
        f"{on['valid']} (JAX CPU {ref['valid_off']} / {ref['valid_on']}); fps {off['fps']:.2f} / "
        f"{on['fps']:.2f}; completion p50 {off['p50']:.2f} / {on['p50']:.2f} ms")
    log(f"[photocal] fits {slam.n_photo_fits}, final rms {rms:.5f}; response rmse to gamma 0.7 "
        f"{err_est:.3f} levels (identity {err_id:.3f}, JAX CPU {ref['err_est']:.3f}; bar "
        f"{0.6 * err_id:.3f}); vignette centre {vm[240, 320]:.5f} corner {vm[0, 0]:.5f}")

    # each fit again, synchronised: its time, and its result against the run's
    fit_ms, redo = [], 0.0
    for args, kw, out in on["fits"]:
        again, ms = _timed(lambda: on["fit"](*args, **kw))
        fit_ms.append(ms)
        redo = max([redo] + [float((a - b).abs().max()) for a, b in zip(out[1:], again[1:])])
    # the first fit once more with its Jacobian by forward-mode AD (the JAX
    # package's route, torch.func.jacfwd) in place of the written-out one
    real_gn = PC._gn_functions

    def ad_gn(*a, **k):
        res, _, n_mask = real_gn(*a, **k)
        return res, torch.func.jacfwd(res), n_mask

    args, kw, _ = on["fits"][0]
    PC._gn_functions = ad_gn
    try:
        on["fit"](*args, **kw)
        ad_ms = [_timed(lambda: on["fit"](*args, **kw))[1] for _ in range(2)]
    finally:
        PC._gn_functions = real_gn
    # the per-frame correction at 480x640
    inv_resp, inv_vig, _ = slam._pc_luts
    raw = torch.from_numpy(frames[-1]).cuda()
    corr_ms = _cuda_ms(lambda: photometric_correct(raw.to(torch.float32), inv_resp, inv_vig))
    log(f"[photocal] {card} | ms per fit (synchronised, again on the run's inputs): "
        f"{' '.join(f'{t:.1f}' for t in fit_ms)}; max |redone - run| {redo:.3g}; the first "
        f"fit with the Jacobian by forward-mode AD {' '.join(f'{t:.1f}' for t in ad_ms)}; "
        f"per-frame correction {corr_ms:.4f} ms (CUDA events, median of 50)")
    # the first fit on the CPU from the same observations
    (obs, r2, mask, exp, known, *_), _, first = on["fits"][0]
    F = obs.shape[1]
    p_cpu, rms_cpu = PC.calibrate(PC.init_params(F, device="cpu"), obs.cpu(), torch.arange(F),
                                  r2.cpu(), mask.cpu(), exp_known=exp.cpu() if known else None)
    d_lut = float((PC.gamma_lut(p_cpu) - PC.gamma_lut(first[0]).cpu()).abs().max())
    d_rms = abs(float(rms_cpu) - float(first[1]))
    log(f"[photocal] first fit ({int(mask.sum())} observations of {obs.shape[0]} points in {F} "
        f"frames, exposure known={known}) redone on the CPU: max|LUT cpu - cuda| {d_lut:.3g} "
        f"levels, |rms cpu - cuda| {d_rms:.3g}")

    failures = []
    if on["valid"] < ref["valid_on"]:
        failures.append(f"{on['valid']} valid poses (JAX CPU {ref['valid_on']})")
    if not on["ate"] <= bar:
        failures.append(f"ATE {on['ate']} above {bar}")
    if not (np.isfinite(rms) and slam.n_photo_fits >= 1):
        failures.append(f"calibrator: {slam.n_photo_fits} fits, rms {rms}")
    if not err_est < 0.6 * err_id:
        failures.append(f"response rmse {err_est} not below 0.6 x identity's {err_id}")
    if not vm[0, 0] < vm[240, 320]:
        failures.append("vignette not darker at the corners")
    if not redo <= 1e-3 or not d_lut <= 0.05 or not d_rms <= 1e-3:
        failures.append(f"the fit redone differs by {redo}, on the CPU by {d_lut} (LUT), "
                        f"{d_rms} (rms)")
    if failures:
        raise AssertionError("photocal: " + "; ".join(failures))
    return off["launches"] + on["launches"]


def _state_leaves(system):
    from hslam_tpu_torch.io import checkpoint as ckpt
    out = {}
    for prefix, tree in (("window", system.window), ("immt", system.imm),
                         ("feats", system.feats), ("template", system.template)):
        out.update(ckpt._named_leaves(tree, prefix))
    out["calib/value"] = system.calib.value
    out["calib/value_zero"] = system.calib.value_zero
    return out


def phase_checkpoint(card):
    """Checkpoint and the metrics stream on the card: the sequential hybrid
    system (no loop closure: a checkpoint carries none of its state) over the
    60-frame arc with its JSONL stream, saved at frame 40 and restored into a
    fresh system; both run on to frame 60."""
    import tempfile
    from hslam_tpu_torch.io import checkpoint as ckpt
    from hslam_tpu_torch.io.synthetic import Scene, make_sequence
    from hslam_tpu_torch.io.trajectory import ate_rmse
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    H, W, FX, SNAP = 480, 640, 320.0, 40
    frames, centres = make_sequence(Scene(H, W, FX), SEQ_FRAMES)
    args = (FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, _hybrid_cfg())
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "metrics.jsonl")
        a = SLAMSystem(*args, enable_loop_closure=False, metrics_path=metrics)
        torch.cuda.synchronize()
        P.kernel_launches = 0
        P.plain_calls = 0
        tracked = []
        for i in range(SNAP):
            if a.initialized:
                tracked.append(i)
            a.process_frame(frames[i], 0.05 * i)
        path = os.path.join(tmp, "state.npz")
        t0 = time.perf_counter()
        ckpt.save_state(path, a)
        t1 = time.perf_counter()
        b = SLAMSystem(*args, enable_loop_closure=False)
        ckpt.load_state(path, b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = os.path.getsize(path)
        la, lb = _state_leaves(a), _state_leaves(b)
        same = la.keys() == lb.keys() and all(
            lb[k].device.type == "cuda" and la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k])
            for k in la)
        same = same and all(np.array_equal(getattr(a, m), getattr(b, m)) for m in ckpt._MIRRORS)
        same = same and [s.cam_to_world.tolist() for s in a.shells] == [
            s.cam_to_world.tolist() for s in b.shells]
        for i in range(SNAP, SEQ_FRAMES):
            tracked.append(i)
            a.process_frame(frames[i], 0.05 * i)
            b.process_frame(frames[i], 0.05 * i)
        torch.cuda.synchronize()
        launches, plain = P.kernel_launches, P.plain_calls
        a.close()
        b.close()
        recs = [json.loads(line) for line in open(metrics)]
    bar = max(1.5 * JAX_CPU_ATE_HYBRID, 0.02)
    out = {}
    for name, s in (("straight", a), ("restored", b)):
        valid = [x.id for x in s.shells if x.pose_valid]
        out[name] = (len(valid), ate_rmse(centres[valid], np.array(
            [s.shells[i].cam_to_world[:3, 3] for i in valid])), s.next_kf_id)
    gap = max(float(np.abs(x.cam_to_world - y.cam_to_world).max())
              for x, y in zip(a.shells, b.shells))
    by_t = {t: [r for r in recs if r["t"] == t] for t in ("frame", "kf", "map")}
    log(f"[checkpoint] {card} | save {1e3 * (t1 - t0):.1f} ms, {size} B; load onto the card "
        f"{1e3 * (t2 - t1):.1f} ms; {len(la)} tensors restored bit for bit: {same}")
    log(f"[checkpoint] on to frame {SEQ_FRAMES}: straight valid {out['straight'][0]} ATE "
        f"{out['straight'][1]:.6f} keyframes {out['straight'][2]}; restored valid "
        f"{out['restored'][0]} ATE {out['restored'][1]:.6f} keyframes {out['restored'][2]} "
        f"(bar {bar:.4f}); max |pose difference| {gap:.3g} (float atomics, not compared); "
        f"pyramid launches {launches} plain {plain}")
    log(f"[metrics] records frame {len(by_t['frame'])} (tracked frames {len(tracked)}), kf "
        f"{len(by_t['kf'])}, map {len(by_t['map'])} (keyframes after the bootstrap "
        f"{a.next_kf_id - 1}); last map record {len(by_t['map'][-1]['pts'])} points, "
        f"{len(by_t['map'][-1]['kfs'])} keyframes")
    failures = []
    if not same:
        failures.append("the restored state is not the saved one bit for bit")
    for name, (nv, ate, _) in out.items():
        if nv != SEQ_FRAMES or not ate <= bar:
            failures.append(f"{name}: {nv} valid poses, ATE {ate}")
    if [r["id"] for r in by_t["frame"]] != tracked:
        failures.append("frame records are not one per tracked frame")
    kf_ids = list(range(1, a.next_kf_id))
    if ([r["kf_id"] for r in by_t["kf"]] != kf_ids
            or [r["kf_id"] for r in by_t["map"]] != kf_ids):
        failures.append("kf/map records are not one per keyframe")
    if not all(np.isfinite(np.asarray(r["pts"], np.float64)).all() and len(r["pts"]) > 0
               for r in by_t["map"]):
        failures.append("a map record holds no or non-finite points")
    if launches != SEQ_FRAMES + (SEQ_FRAMES - SNAP) or plain != 0:
        failures.append(f"pyramid launches {launches}, plain {plain}")
    if failures:
        raise AssertionError("checkpoint: " + "; ".join(failures))
    return launches


GBA_W, GBA_H, GBA_F = 128, 96, 80.0
GBA_K = np.array([[GBA_F, 0, GBA_W / 2 - 0.5], [0, GBA_F, GBA_H / 2 - 0.5], [0, 0, 1.0]])


def _gba_problem(N=256, ppk=4, radius=3, pose_noise=0.015, rho_noise=0.05, seed=6):
    """tests/test_global_ba.py's _make_problem in numpy (the 256-keyframe
    case of its test_256kf_sharded_long_trajectory): a sideways arc over the
    plane z = 2, landmarks lifted from it, poses but the first and inverse
    depths perturbed. Returns the port's GlobalBA on the CPU."""
    from hslam_tpu_torch.io.synthetic import se3_exp_np
    from hslam_tpu_torch.parallel import global_ba as G
    rng = np.random.default_rng(seed)
    Rs, ts = [], []
    for i in range(N):
        a = 0.06 * i
        R, t = se3_exp_np(np.array([0.9 * np.sin(a), 0.5 * (1 - np.cos(a)), 0.15 * np.sin(0.7 * a),
                                    0.03 * np.sin(0.9 * a), 0.04 * np.sin(0.6 * a),
                                    0.02 * np.sin(0.5 * a)]))
        Rs.append(R.T)
        ts.append(-R.T @ t)
    fx, cx, cy = GBA_K[0, 0], GBA_K[0, 2], GBA_K[1, 2]

    def depth_fn(u, v, i):
        C = -Rs[i].T @ ts[i]
        rw = Rs[i].T @ np.array([(u - cx) / fx, (v - cy) / fx, 1.0])
        return (2.0 - C[2]) / max(rw[2], 1e-6)

    prob = G.build_problem_from_trajectory(Rs, ts, GBA_K, ppk, radius, GBA_W, GBA_H, rng,
                                           depth_fn, pix_noise=0.1, device="cpu")
    R_n, t_n = [prob.R[0].double().numpy()], [prob.t[0].double().numpy()]
    for i in range(1, N):
        dR, dt = se3_exp_np(rng.normal(0, pose_noise, 6) * np.array([1, 1, 1, .5, .5, .5]))
        R_n.append(dR @ prob.R[i].double().numpy())
        t_n.append(dR @ prob.t[i].double().numpy() + dt)
    rho = prob.rho.double().numpy() * np.exp(rng.normal(0, rho_noise, prob.rho.shape[0]))
    return prob._replace(R=torch.as_tensor(np.stack(R_n), dtype=torch.float32),
                         t=torch.as_tensor(np.stack(t_n), dtype=torch.float32),
                         rho=torch.as_tensor(rho, dtype=torch.float32))


def _to(tree, dev):
    """Tensors of a tree of (named) tuples moved to `dev`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if not isinstance(tree, tuple):
        return tree
    vals = [_to(x, dev) for x in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for y in tree for x in _leaves(y)] if isinstance(tree, tuple) else []


def _ba_collectives(mesh, wnd, calib, cfg):
    """(collectives, bytes) of one sharded optimize outside its GN loop, and
    of one GN iteration: the counters around calls of 1 and 2 iterations,
    on the window with its frames moved by 1e-3 in every pose direction so
    that the first iteration does not converge."""
    from hslam_tpu_torch.parallel.dist_ba import sharded_ba_optimize
    st = wnd.frames.state.clone()
    st[:, :6] += 1e-3
    moved = wnd._replace(frames=wnd.frames._replace(state=st))
    out = []
    for n in (1, 2):
        c, b = mesh.n_collectives, mesh.n_bytes
        sharded_ba_optimize(mesh, moved, calib, cfg, n)
        out.append((mesh.n_collectives - c, mesh.n_bytes - b))
    per_iter = (out[1][0] - out[0][0], out[1][1] - out[0][1])
    return (out[0][0] - per_iter[0], out[0][1] - per_iter[1]), per_iter


def _allreduce_ms(mesh, numel, reps=50):
    """ms of one float32 all_reduce of `numel` values followed by a host
    sync, as a CG iteration issues it (psum, then its stopping test)."""
    from hslam_tpu_torch.parallel.distributed import psum
    x = torch.ones(numel, device="cuda")
    float(psum(x, mesh)[0])
    return _timed(lambda: [float(psum(x, mesh)[0]) for _ in range(reps)])[1] / reps


def _median_ms(fn, reps=3):
    fn()
    return float(np.median([_timed(fn)[1] for _ in range(reps)]))


def _p14_pipelined(mesh, frames, sleep_rank=None, ckpt=None):
    """Phase 7's main path on this rank of `mesh`: the default hybrid system
    with loop closure and dist_mesh, through process_frame_pipelined,
    flush_pipeline and finish; `sleep_rank`'s mapping thread sleeps 0.1 s
    before each step. On two ranks rank 0 tracks and decides and rank 1
    replays. The pyramid counts are set to 0 just before the run and read
    just after it. With `ckpt` (a path), the rank then saves its state
    there (io/checkpoint)."""
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    from hslam_tpu_torch.ops import tracker as T
    H, W, FX = 480, 640, 320.0
    slam = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, _hybrid_cfg(), sequential=False,
                      dist_mesh=mesh)
    if mesh.rank == sleep_rank:
        execute = slam._map_execute

        def slow(*step):
            time.sleep(0.1)
            return execute(*step)
        slam._map_execute = slow
    try:
        torch.cuda.synchronize()
        P.kernel_launches = 0
        P.plain_calls = 0
        T.kernel_launches = 0
        T.plain_calls = 0
        tracked = 0
        t_all = time.perf_counter()
        for i, f in enumerate(frames):
            tracked += slam.initialized
            slam.process_frame_pipelined(f, 0.05 * i)
            torch.cuda.synchronize()          # as phase 7 times its frames
        slam.flush_pipeline()
        slam.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
        launches, plain = P.kernel_launches, P.plain_calls
        t_launches, t_plain = T.kernel_launches, T.plain_calls
        if ckpt is not None:
            from hslam_tpu_torch.io.checkpoint import save_state
            save_state(ckpt, slam)
    finally:
        slam.close()
    channels = {k: None if c is None else (c.n_broadcasts, c.seconds)
                for k, c in (("trk", slam._trk), ("map", slam._map))}
    lc = slam.loop_closer
    return dict(poses=np.stack([s.cam_to_world for s in slam.shells]),
                valid=[s.pose_valid for s in slam.shells], keyframes=slam.next_kf_id,
                initialized=slam.initialized, lost=slam.is_lost, retries=slam.n_track_retries,
                skipped=slam.n_frames_skipped, launches=launches, plain=plain, tracked=tracked,
                track_launches=t_launches, track_plain=t_plain,
                fps=len(frames) / wall, ind_obs=sum(slam.ind_obs_history),
                lc_entries=-1 if lc is None else len(lc.entries), loops=slam.n_loops_closed,
                follower=slam._follower, **channels)


def _pipelined_failures(tag, r, centres, leader=True):
    """Phase 7's bars on one rank's _p14_pipelined result; a follower builds
    one pyramid per frame and tracks nothing. Returns (ATE, failures)."""
    from hslam_tpu_torch.io.trajectory import ate_rmse
    n = len(r["valid"])
    valid = [i for i, v in enumerate(r["valid"]) if v]
    ate = float(ate_rmse(centres[valid], r["poses"][valid, :3, 3])) if valid else float("nan")
    bar = max(1.5 * JAX_CPU_ATE_HYBRID, 0.02)
    out = []
    if not r["initialized"] or r["lost"] or len(valid) != n or not np.all(np.isfinite(r["poses"])):
        out.append(f"{tag}: {len(valid)}/{n} valid poses, lost {r['lost']}")
    if not ate <= bar:
        out.append(f"{tag}: ATE {ate} above {bar}")
    if r["keyframes"] < 3 or abs(r["keyframes"] - JAX_CPU_KFS_HYBRID) > 1:
        out.append(f"{tag}: {r['keyframes']} keyframes (JAX CPU {JAX_CPU_KFS_HYBRID})")
    if r["ind_obs"] <= 0:
        out.append(f"{tag}: no indirect observation reached the BA")
    if r["lc_entries"] < r["keyframes"] - 1:
        out.append(f"{tag}: loop-closure worker saw {r['lc_entries']} of {r['keyframes']} keyframes")
    want = n + r["retries"] if leader else n
    if r["launches"] != want or r["plain"] != 0:
        out.append(f"{tag}: pyramid launches {r['launches']} (want {want}), plain {r['plain']}")
    want = 2 * (r["tracked"] + r["retries"]) if leader else 0
    if r["track_launches"] != want or r["track_plain"] != 0:
        out.append(f"{tag}: tracker kernel launches {r['track_launches']} (want {want}), plain "
                   f"{r['track_plain']}")
    return ate, out


def _p14_world_of_one(mesh, wnd, calib, cfg, marg, pg_args, frames):
    """(a), on one rank over NCCL: every sharded call against its unsharded
    call on the same inputs, torch.equal leaf by leaf, and their times; then
    the pipelined main path with dist_mesh (a world of one sends nothing)."""
    from hslam_tpu_torch.models import optimizer as O
    from hslam_tpu_torch.models import pose_graph as PG
    from hslam_tpu_torch.parallel.dist_ba import sharded_ba_optimize, sharded_marginalize_points
    from hslam_tpu_torch.parallel.dist_pose_graph import sharded_optimize_pose_graph_pcg
    torch.cuda.set_device(0)
    wnd, calib, (tm, td) = _to(wnd, "cuda"), _to(calib, "cuda"), _to(marg, "cuda")
    it = cfg.max_opt_iterations
    fixed, per_iter = _ba_collectives(mesh, wnd, calib, cfg)
    a = sharded_ba_optimize(mesh, wnd, calib, cfg, it)
    b = O.ba_optimize(wnd, calib, cfg, it)
    ma = sharded_marginalize_points(mesh, wnd, calib, tm, td, cfg)
    mb = O.marginalize_points(wnd, calib, tm, td, cfg)
    pg = PG.make_graph(*pg_args, device="cuda")
    edges = mesh.split("edges")
    sharded_optimize_pose_graph_pcg(edges, pg, n_iters=1, cg_iters=2)        # warm-up
    PG.optimize_pose_graph_pcg(pg, n_iters=1, cg_iters=2)
    pa, pcg_ms = _timed(lambda: sharded_optimize_pose_graph_pcg(edges, pg, n_iters=5, cg_iters=1000))
    pb, pcg_plain_ms = _timed(lambda: PG.optimize_pose_graph_pcg(pg, n_iters=5, cg_iters=1000))
    eq = {k: all(torch.equal(x, y) for x, y in zip(_leaves(u), _leaves(v)))
          for k, (u, v) in dict(ba=(a, b), marginalize=(ma, mb), pcg=(pa, pb)).items()}
    return dict(equal=eq, fixed=fixed, per_iter=per_iter,
                allreduce_ms={n: _allreduce_ms(edges, n) for n in (9387, 70000)},
                ba_ms=_median_ms(lambda: sharded_ba_optimize(mesh, wnd, calib, cfg, it)),
                ba_plain_ms=_median_ms(lambda: O.ba_optimize(wnd, calib, cfg, it)),
                pcg_ms=pcg_ms, pcg_plain_ms=pcg_plain_ms,
                pipelined=_p14_pipelined(mesh, frames))


def _p14_two_ranks(mesh, wnd, cond, calib, cfg, marg, pg_args, gba, frames, ckpt_dir):
    """(b), on each of two ranks over Gloo, both on the one card: the
    sharded calls, then the system over the arc with dist_mesh; each
    pipelined run's state saved into `ckpt_dir` by each rank."""
    from hslam_tpu_torch.models import pose_graph as PG
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    from hslam_tpu_torch.parallel.dist_ba import sharded_ba_optimize, sharded_marginalize_points
    from hslam_tpu_torch.parallel.dist_pose_graph import sharded_optimize_pose_graph_pcg
    from hslam_tpu_torch.parallel.global_ba import sharded_global_ba
    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))   # two ranks on one host
    wnd, cond, calib = _to(wnd, "cuda"), _to(cond, "cuda"), _to(calib, "cuda")
    tm, td = _to(marg, "cuda")
    it = cfg.max_opt_iterations
    fixed, per_iter = _ba_collectives(mesh, wnd, calib, cfg)
    r = sharded_ba_optimize(mesh, cond, calib, cfg, it)
    ba_ms = _median_ms(lambda: sharded_ba_optimize(mesh, cond, calib, cfg, it))
    raw = sharded_ba_optimize(mesh, wnd, calib, cfg, it)
    m = sharded_marginalize_points(mesh, wnd, calib, tm, td, cfg)
    pg = PG.make_graph(*pg_args, device="cuda")
    edges = mesh.split("edges")
    sharded_optimize_pose_graph_pcg(edges, pg, n_iters=1, cg_iters=2)        # warm-up
    pcg, pcg_ms = _timed(lambda: sharded_optimize_pose_graph_pcg(
        edges, pg, n_iters=5, cg_iters=1000))
    kfb, gba = mesh.split("kfblocks"), _to(gba, "cuda")
    sharded_global_ba(kfb, gba, GBA_K, n_iters=1, cg_iters=2)                  # warm-up
    (gp, chis), gba_ms = _timed(lambda: sharded_global_ba(kfb, gba, GBA_K))
    np_ = lambda xs: [x.cpu().numpy() for x in xs]  # noqa: E731
    out = dict(
        fixed=fixed, per_iter=per_iter, ba_ms=ba_ms, pcg_ms=pcg_ms, gba_ms=gba_ms,
        allreduce_ms={n: _allreduce_ms(edges, n) for n in (9387, 70000)},
        ba=np_((r.rmse, r.window.frames.state, r.calib.value, r.window.points.idepth,
                r.window.points.res_state, r.window.frames.energy_th)),
        ba_raw=np_((raw.rmse, raw.window.frames.state, raw.window.points.idepth)),
        marginalize=np_((m.HM, m.bM, m.points.status)), pcg=np_(pcg),
        global_ba=np_((chis, gp.t, gp.R, gp.rho)))
    # the system: the default hybrid configuration through process_frame
    H, W, FX = 480, 640, 320.0
    slam = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, _hybrid_cfg(), dist_mesh=mesh)
    torch.cuda.synchronize()
    P.kernel_launches = 0
    P.plain_calls = 0
    c0, b0 = mesh.n_collectives, mesh.n_bytes
    kf_ms = []
    t_all = time.perf_counter()
    for i, f in enumerate(frames):
        shell, ms = _timed(lambda: slam.process_frame(f, 0.05 * i))
        if shell.is_kf:
            kf_ms.append(ms)
    wall = time.perf_counter() - t_all
    out["system"] = dict(
        launches=P.kernel_launches, plain=P.plain_calls, retries=slam.n_track_retries,
        keyframes=slam.next_kf_id, lost=slam.is_lost, wall=wall, kf_ms=kf_ms,
        collectives=mesh.n_collectives - c0, bytes=mesh.n_bytes - b0,
        valid=[s.pose_valid for s in slam.shells],
        poses=np.stack([s.cam_to_world for s in slam.shells]))
    slam.close()
    # the pipelined main path in lockstep (rank 0 decides, rank 1 replays),
    # then again with rank 1's mapping thread slowed
    for key, sleep_rank in (("pipelined", None), ("pipelined_sleep", 1)):
        out[key] = _p14_pipelined(mesh, frames, sleep_rank,
                                  os.path.join(ckpt_dir, f"{key}_rank{mesh.rank}.npz"))
    return out


def _same_checkpoint_files(a, b):
    """(keys, arrays that differ) between two io/checkpoint files: each
    array, __meta__ included, compared by dtype, shape and bytes."""
    da, db = np.load(a), np.load(b)
    diff = sorted(k for k in set(da.files) | set(db.files)
                  if k not in da.files or k not in db.files or da[k].dtype != db[k].dtype
                  or da[k].shape != db[k].shape or da[k].tobytes() != db[k].tobytes())
    return len(da.files), diff


def phase_distributed(card):
    """The point-sharded BA and marginalization, the edge-sharded PCG and the
    sharded global BA on the card, and SLAMSystem(dist_mesh=...): (a) a
    world of one over NCCL, bit for bit against the unsharded calls; (b) two
    ranks over Gloo on the one card, against the unsharded calls and the
    single-process system run; (c) dryrun_multichip(2). Each rank is a
    spawned process; a rank that fails or hangs fails the phase."""
    from hslam_tpu_torch.config import CPARS
    from hslam_tpu_torch.io.checkpoint import load_state
    from hslam_tpu_torch.io.synthetic import Scene, make_sequence
    from hslam_tpu_torch.io.trajectory import ate_rmse
    from hslam_tpu_torch.models import optimizer as O
    from hslam_tpu_torch.models import pose_graph as PG
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    from hslam_tpu_torch.parallel.distributed import run_ranks
    from hslam_tpu_torch.parallel.dryrun import dryrun_multichip
    from hslam_tpu_torch.parallel.global_ba import global_ba, partition_problem
    t_phase = time.perf_counter()
    H, W, FX = 480, 640, 320.0
    cfg = _hybrid_cfg()
    frames, centres = make_sequence(Scene(H, W, FX), SEQ_FRAMES)
    # the single-process run: the bars of (b) and the window of the calls
    slam = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, cfg)
    torch.cuda.synchronize()
    P.kernel_launches = 0
    P.plain_calls = 0
    for i, f in enumerate(frames):
        slam.process_frame(f, 0.05 * i)
    torch.cuda.synchronize()
    launches, plain, builds = P.kernel_launches, P.plain_calls, SEQ_FRAMES + slam.n_track_retries
    slam.close()
    valid1 = [s.id for s in slam.shells if s.pose_valid]
    ate1 = ate_rmse(centres[valid1], np.array([slam.shells[i].cam_to_world[:3, 3] for i in valid1]))
    kfs1 = slam.next_kf_id
    wnd, calib = slam.window, slam.calib
    P_ = cfg.max_points
    n_act = int((wnd.points.status == 1).sum())
    tm = (torch.arange(P_, device="cuda") % 5 == 0) & (wnd.points.status == 1)
    td = (torch.arange(P_, device="cuda") % 7 == 3) & ~tm
    # tests/test_dist.py's conditioning for the two-rank optimize: frame
    # priors of 1e8, so the comparison reads the reductions and not f32
    # noise amplified along the gauge
    cond = wnd._replace(frames=wnd.frames._replace(prior=torch.full_like(wnd.frames.prior, 1e8)))
    it = cfg.max_opt_iterations
    rs = O.ba_optimize(cond, calib, cfg, it)
    ba_plain_ms = _median_ms(lambda: O.ba_optimize(cond, calib, cfg, it))
    raw = O.ba_optimize(wnd, calib, cfg, it)
    ms = O.marginalize_points(wnd, calib, tm, td, cfg)
    # the control of (b)'s marginalization check: rank 1's block of flagged
    # points dropped, as a reduction that lost a rank would give
    tm0 = tm.clone()
    tm0[P_ // 2:] = False
    ctl = O.marginalize_points(wnd, calib, tm0, td, cfg)
    pg_args = _circle_graph(10_000, scale_drift=1.00005, noise=0.002)
    pg = PG.make_graph(*pg_args, device="cuda")
    PG.optimize_pose_graph_pcg(pg, n_iters=1, cg_iters=2)                    # warm-up
    pcg1, pcg_plain_ms = _timed(lambda: PG.optimize_pose_graph_pcg(pg, n_iters=5, cg_iters=1000))
    gba = partition_problem(_gba_problem(), 2)
    global_ba(_to(gba, "cuda"), GBA_K, n_iters=1, cg_iters=2)                 # warm-up
    (gp1, chis1), gba_plain_ms = _timed(lambda: global_ba(_to(gba, "cuda"), GBA_K))
    log(f"[distributed] {card} | single process, sequential default hybrid system: "
        f"keyframes {kfs1}, valid {len(valid1)}/{SEQ_FRAMES}, ATE {ate1:.6f}; window "
        f"{n_act} active points of {P_}, {int(tm.sum())} flagged to marginalize")

    cpu = lambda t: _to(t, "cpu")  # noqa: E731
    marg = (tm.cpu(), td.cpu())
    # (a) a world of one over NCCL
    a, = run_ranks(_p14_world_of_one, 1, args=(cpu(wnd), cpu(calib), cfg, marg, pg_args, frames),
                   backend="nccl", timeout=400)
    log(f"[distributed] {card} | (a) 1 rank NCCL: sharded == unsharded (torch.equal) "
        f"{a['equal']}; BA per keyframe ({it} GN iterations at most) {a['ba_ms']:.2f} ms "
        f"sharded vs {a['ba_plain_ms']:.2f} unsharded; PCG 10,000 nodes {a['pcg_ms']:.1f} ms "
        f"sharded vs {a['pcg_plain_ms']:.1f} unsharded")
    log(f"[distributed] collectives (count, bytes) per GN iteration {a['per_iter']}, outside "
        f"the loop {a['fixed']}, per optimize call; ms per all_reduce with a host sync, by "
        f"float32 values (the BA's camera system, the PCG's node vector): {a['allreduce_ms']}")
    failures = [f"(a) {k} differs from unsharded" for k, ok in a["equal"].items() if not ok]
    pa = a["pipelined"]
    ate_a, bad = _pipelined_failures("(a) pipelined", pa, centres)
    failures += bad
    log(f"[distributed] {card} | (a) pipelined main path, dist_mesh of 1 (no control records: "
        f"{pa['trk'] is None and pa['map'] is None}): keyframes {pa['keyframes']} (JAX CPU "
        f"{JAX_CPU_KFS_HYBRID}), valid {sum(pa['valid'])}/{SEQ_FRAMES}, ATE {ate_a:.6f}, fps "
        f"{pa['fps']:.2f} (phase 7 {RESULTS.get('pipelined_fps', float('nan')):.2f}), retries "
        f"{pa['retries']}, skipped {pa['skipped']}, pyramid launches {pa['launches']}, plain "
        f"{pa['plain']}, loop-closure entries {pa['lc_entries']}")
    if pa["trk"] is not None or pa["map"] is not None:
        failures.append("(a) a world of one made control channels")

    # (b) two ranks over Gloo, both on the card
    import tempfile
    ckpt_dir = tempfile.mkdtemp(prefix="p14_ckpt_")
    r0, r1 = run_ranks(_p14_two_ranks, 2, args=(cpu(wnd), cpu(cond), cpu(calib), cfg, marg,
                                                pg_args, gba, frames, ckpt_dir),
                       backend="gloo", timeout=900)
    same = all(np.array_equal(x, y) for k in ("ba", "ba_raw", "marginalize", "pcg", "global_ba")
               for x, y in zip(r0[k], r1[k]))
    s0, s1 = r0["system"], r1["system"]
    same_traj = np.array_equal(s0["poses"], s1["poses"]) and s0["valid"] == s1["valid"]
    errs = {}

    def held(name, got, want, rtol=0.0, atol=0.0):
        want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) else want
        gap = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
        errs[name] = gap
        if not np.allclose(got, want, rtol=rtol, atol=atol):
            failures.append(f"(b) {name}: max |difference| {gap:.3g} beyond rtol {rtol} atol {atol}")

    rmse, state, cal, idepth, res_state, eth = r0["ba"]
    held("ba rmse", rmse, rs.rmse, rtol=1e-4)
    held("ba state", state, rs.window.frames.state, rtol=1e-4, atol=1e-5)
    held("ba calib", cal, rs.calib.value, rtol=1e-5)
    held("ba idepth", idepth, rs.window.points.idepth, rtol=1e-3, atol=1e-4)
    held("ba res_state", res_state, rs.window.points.res_state)
    held("ba energy_th", eth, rs.window.frames.energy_th, rtol=1e-4)
    for name, x, y in zip(("rmse", "state", "idepth"), r0["ba_raw"],
                          (raw.rmse, raw.window.frames.state, raw.window.points.idepth)):
        errs[f"unconditioned ba {name}"] = float(np.max(np.abs(x - y.cpu().numpy())))
    # HM and bM hold f32 differences of sums near 1e10 (H_top - H_sc): the
    # reduction order moves an entry by about one f32 ulp of the matrix's
    # largest, so rtol 1e-4 and atol 1e-2 take a floor of 16 such ulps
    HM1, bM1 = ms.HM.cpu().numpy(), ms.bM.cpu().numpy()
    f32_atol = lambda ref: 1e-2 + 16 * np.finfo(np.float32).eps * np.abs(ref).max()  # noqa: E731
    held("marginalize HM", r0["marginalize"][0], HM1, rtol=1e-4, atol=f32_atol(HM1))
    held("marginalize bM", r0["marginalize"][1], bM1, rtol=1e-4, atol=f32_atol(bM1))
    # the block of the calibration and the affine brightness: small entries
    small = np.r_[np.arange(CPARS),
                  CPARS + np.flatnonzero(np.arange(8 * cfg.max_frames) % 8 >= 6)]
    small = np.ix_(small, small)
    gap_small = float(np.abs(np.asarray(r0["marginalize"][0]) - HM1)[small].max())
    HMc = ctl.HM.cpu().numpy()
    caught = not np.allclose(HMc, HM1, rtol=1e-4, atol=f32_atol(HM1))
    log(f"[distributed] (b) marginalize: max |HM| {np.abs(HM1).max():.4g}, max |bM| "
        f"{np.abs(bM1).max():.4g}; HM limit 1e-4 |HM_ij| + {f32_atol(HM1):.4g}, bM limit "
        f"1e-4 |bM_i| + {f32_atol(bM1):.4g}; two ranks' HM gap in the calibration and affine "
        f"block {gap_small:.3g}; control (rank 1's block dropped) HM gap "
        f"{float(np.abs(HMc - HM1).max()):.4g}, in that block "
        f"{float(np.abs(HMc - HM1)[small].max()):.4g}, caught by the check: {caught}")
    if not caught:
        failures.append("(b) the marginalization check passes a dropped rank's block")
    held("marginalize status", r0["marginalize"][2], ms.points.status)
    held("pcg s", r0["pcg"][0], pcg1[0], rtol=2e-3, atol=2e-4)
    held("pcg t", r0["pcg"][2], pcg1[2], atol=5e-3)
    chi_1 = _chi2(pg, pcg1)
    chi_2 = _chi2(pg, [torch.as_tensor(x, device="cuda") for x in r0["pcg"]])
    if not chi_2 <= 1.05 * chi_1 + 1e-6:
        failures.append(f"(b) pcg chi2 {chi_2} above 1.05 x {chi_1}")
    held("global_ba chi2", r0["global_ba"][0], chis1, rtol=2e-3)
    held("global_ba t", r0["global_ba"][1], gp1.t, atol=2e-3)
    held("global_ba R", r0["global_ba"][2], gp1.R, atol=2e-3)
    held("global_ba rho", r0["global_ba"][3], gp1.rho, atol=5e-3)
    valid = [i for i, v in enumerate(s0["valid"]) if v]
    ate = ate_rmse(centres[valid], s0["poses"][valid, :3, 3])
    log(f"[distributed] {card} | (b) 2 ranks Gloo on one card: ranks equal bit for bit: calls "
        f"{same}, trajectories {same_traj}; BA per keyframe {r0['ba_ms']:.2f} / "
        f"{r1['ba_ms']:.2f} ms (ranks 0 / 1) vs {ba_plain_ms:.2f} unsharded; PCG 10,000 nodes "
        f"{r0['pcg_ms']:.1f} / {r1['pcg_ms']:.1f} ms vs {pcg_plain_ms:.1f}; global BA 256 "
        f"keyframes {r0['gba_ms']:.1f} ms vs {gba_plain_ms:.1f}; collectives (count, bytes) "
        f"per GN iteration {r0['per_iter']}, outside the loop {r0['fixed']}; ms per "
        f"all_reduce with a host sync {r0['allreduce_ms']}")
    log("[distributed] (b) max |two ranks - unsharded|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    log(f"[distributed] (b) system, dist_mesh of 2: keyframes {s0['keyframes']} (single process "
        f"{kfs1}), valid {len(valid)}/{SEQ_FRAMES}, ATE {ate:.6f} (bar 0.02; single process "
        f"{ate1:.6f}), lost {s0['lost']}, wall {s0['wall']:.1f} / {s1['wall']:.1f} s, keyframe "
        f"ms p50 {float(np.median(s0['kf_ms'])) if s0['kf_ms'] else float('nan'):.1f}; "
        f"collectives {s0['collectives']} ({s0['bytes']} B); pyramid launches "
        f"{s0['launches']} + {s1['launches']}, plain {s0['plain'] + s1['plain']}")
    if not same or not same_traj:
        failures.append("(b) the two ranks differ")
    if not ate <= 0.02 or len(valid) != SEQ_FRAMES or s0["lost"]:
        failures.append(f"(b) system: {len(valid)} valid poses, ATE {ate}")
    if abs(s0["keyframes"] - kfs1) > 1:
        failures.append(f"(b) {s0['keyframes']} keyframes, single process {kfs1}")
    for s in (s0, s1):
        if s["launches"] != SEQ_FRAMES + s["retries"] or s["plain"] != 0:
            failures.append(f"(b) pyramid launches {s['launches']}, plain {s['plain']}")
    lockstep_launches = 0
    for key, what in (("pipelined", "pipelined main path"),
                      ("pipelined_sleep", "pipelined main path, rank 1's mapping thread "
                                          "sleeping 0.1 s a step")):
        p0, p1 = r0[key], r1[key]
        same = np.array_equal(p0["poses"], p1["poses"]) and p0["valid"] == p1["valid"]
        ate_p, bad = _pipelined_failures(f"(b) {key}", p0, centres)
        failures += bad + _pipelined_failures(f"(b) {key} rank 1", p1, centres, leader=False)[1]
        if not same:
            failures.append(f"(b) {key}: the two ranks' trajectories differ")
        if p0["follower"] or not p1["follower"]:
            failures.append(f"(b) {key}: roles {p0['follower']}, {p1['follower']}")
        (t0n, t0s), (m0n, m0s) = p0["trk"], p0["map"]
        (t1n, t1s), (m1n, m1s) = p1["trk"], p1["map"]
        log(f"[distributed] {card} | (b) {what}, 2 ranks Gloo: trajectories and validity equal "
            f"bit for bit {same}; keyframes {p0['keyframes']} / {p1['keyframes']} (JAX CPU "
            f"{JAX_CPU_KFS_HYBRID}), valid {sum(p0['valid'])}/{SEQ_FRAMES}, ATE {ate_p:.6f} "
            f"(bar 0.02), lost {p0['lost']}; fps {p0['fps']:.2f} / {p1['fps']:.2f} (ranks 0 / 1; "
            f"phase 7, one process: {RESULTS.get('pipelined_fps', float('nan')):.2f}); retries "
            f"{p0['retries']}, skipped {p0['skipped']} / {p1['skipped']}, loop-closure entries "
            f"{p0['lc_entries']} / {p1['lc_entries']}, loops closed {p0['loops']} / {p1['loops']}; "
            f"pyramid launches {p0['launches']} (= {SEQ_FRAMES} + {p0['retries']} retries) / "
            f"{p1['launches']}, plain {p0['plain'] + p1['plain']}")
        # C21: the follower holds rank 0's tracking reference, so its
        # checkpoint is rank 0's, array for array; each file loads back
        files = [os.path.join(ckpt_dir, f"{key}_rank{r}.npz") for r in (0, 1)]
        n_keys, diff = _same_checkpoint_files(*files)
        restored = []
        for f in files:
            sys_ = SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, cfg,
                              enable_loop_closure=False)
            load_state(f, sys_)
            restored.append(_state_leaves(sys_))
        same_load = restored[0].keys() == restored[1].keys() and all(
            torch.equal(restored[0][k], restored[1][k]) for k in restored[0])
        log(f"[distributed] (b) {key} save_state on each rank: {n_keys} arrays, "
            f"{os.path.getsize(files[0])} / {os.path.getsize(files[1])} B; arrays that differ "
            f"(__meta__ included) {diff}; both load into fresh systems alike: {same_load} "
            f"({len(restored[0])} tensors)")
        if diff or not same_load:
            failures.append(f"(b) {key}: rank 1's checkpoint differs from rank 0's in {diff} "
                            f"(loaded alike: {same_load})")
        log(f"[distributed] (b) {key} control broadcasts (host clock, ranks 0 / 1): tracking "
            f"{t0n} ({t0n / SEQ_FRAMES:.2f} per frame, {1e3 * t0s / SEQ_FRAMES:.3f} / "
            f"{1e3 * t1s / SEQ_FRAMES:.3f} ms per frame), mapping {m0n} ({m0n - 1} steps and the "
            f"end mark; {1e3 * m0s / max(m0n, 1):.3f} / {1e3 * m1s / max(m1n, 1):.3f} ms per step)")
        lockstep_launches += p0["launches"] + p1["launches"]
    if launches != builds or plain != 0:
        failures.append(f"single process: pyramid launches {launches}, plain {plain}")

    import shutil
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    # (c) the multi-rank self-check
    msg = dryrun_multichip(2, device="cuda")
    log(f"[distributed] (c) {msg}")
    log(f"[distributed] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("distributed: " + "; ".join(failures))
    return launches + s0["launches"] + s1["launches"] + pa["launches"] + lockstep_launches


LOADER_RTOL, LOADER_ATOL = 1e-5, 1e-3   # tests/test_native_loader.py:117,150


def _correction_gaps(root):
    """The first raw frame's correction and remap, card against CPU (max
    |diff|); then every frame through the prefetching loader (host, two
    threads) against FrameCorrector on the card: max |diff| and whether all
    are within LOADER_RTOL, LOADER_ATOL."""
    from hslam_tpu_torch.io.dataset import DatasetReader
    from hslam_tpu_torch.tools.run_sequence import FrameCorrector, open_loader
    rd = DatasetReader(root)
    loader = open_loader(rd, True)
    try:
        raw = torch.from_numpy(rd.get_raw(0).image)
        card = FrameCorrector(rd, True, "cuda")
        out = [FrameCorrector(rd, True, dev)(raw.to(dev)).cpu() for dev in ("cuda", "cpu")]
        gap, ok = 0.0, True
        for i in range(len(rd)):
            got = torch.from_numpy(loader.get(i))
            want = card(torch.from_numpy(rd.get_raw(i).image).cuda()).cpu()
            gap = max(gap, float((got - want).abs().max()))
            ok &= bool(torch.allclose(got, want, rtol=LOADER_RTOL, atol=LOADER_ATOL))
    finally:
        loader.close()
        rd.close()
    return tuple(raw.shape), float((out[0] - out[1]).abs().max()), gap, ok


def _online_calib_run(card, root, gt, tmp, extra, failures):
    """Phase 15 (d): run_sequence --online-calib on the TUM fixture (the
    frames remapped, not corrected), held to the bars of the TUM run and of
    phase 12's calibration; each fit recorded, then redone synchronised for
    its ms. Returns the keyframed frames and the pyramid launches."""
    from hslam_tpu_torch.io.trajectory import associate, evaluate_ate, read_tum
    from hslam_tpu_torch.models import photo_calib as PC
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    from hslam_tpu_torch.tools import run_sequence as RS
    fits, real_fit = [], SLAMSystem._pc_fit

    def recording_fit(self, *args, **kw):
        fits.append((self, args, kw))
        return real_fit(self, *args, **kw)

    out = os.path.join(tmp, "traj_tum_online.txt")
    SLAMSystem._pc_fit = recording_fit
    try:
        P.kernel_launches = 0
        P.plain_calls = 0
        res = RS.run(RS.parse_args(["--dataset", root, "--out", out, "--online-calib"] + extra))
        launches, plain = P.kernel_launches, P.plain_calls
    finally:
        SLAMSystem._pc_fit = real_fit
    slam, ref = res.system, JAX_CPU_DATASET["tum_online"]
    slam.close()
    n = res.n_frames
    fit_ms = [_timed(lambda: real_fit(obj, *args, **kw))[1] for obj, args, kw in fits]
    ate = evaluate_ate(gt, out)
    matched = len(associate(read_tum(gt)[0], read_tum(out)[0]))
    valid = sum(s.pose_valid for s in slam.shells)
    kfs = [s.id for s in slam.shells if s.is_kf]
    bar = max(1.5 * ref["ate"], 0.02)
    x = np.arange(256.0)
    truth = 255.0 * (x / 255.0) ** 0.7
    err_id = float(np.sqrt(np.mean((x - truth) ** 2)))
    err_est, vm = float("nan"), None
    if slam._pc_params is not None:
        lut = PC.gamma_lut(slam._pc_params).cpu().numpy().astype(np.float64)
        err_est = float(np.sqrt(np.mean((lut - truth) ** 2)))
        vm = PC.vignette_map(slam._pc_params, slam.height, slam.width).cpu().numpy()
    centre = vm[slam.height // 2, slam.width // 2] if vm is not None else float("nan")
    corner = vm[0, 0] if vm is not None else float("nan")
    tag = "(d) tum --online-calib" + (", inline" if "--no-prefetch" in extra else "")
    log(f"[dataset] {tag}: {card} | {n} frames in {res.seconds:.2f} s, fps "
        f"{n / res.seconds:.2f}; per frame {res.times.summary()}")
    log(f"[dataset] {tag}: valid {valid}/{n} lost {slam.is_lost} keyframes {len(kfs)} at {kfs} "
        f"(JAX CPU {ref['kf_frames']}); gt matched {matched}; ATE {ate:.6f} (bar {bar:.4f}, JAX "
        f"CPU {ref['ate']:.6f}); fits {slam.n_photo_fits}, ms per fit (synchronised, again on "
        f"the run's inputs) {' '.join(f'{t:.1f}' for t in fit_ms)}; response rmse to gamma "
        f"0.7 {err_est:.3f} levels (identity {err_id:.3f}, bar {0.6 * err_id:.3f}); vignette "
        f"centre {centre:.5f} corner {corner:.5f}; pyramid launches {launches} plain {plain}")
    if valid != n or slam.is_lost or len(kfs) < 3 or matched < 55 or not ate <= bar:
        failures.append(f"{tag}: valid {valid} keyframes {len(kfs)} matched {matched} ATE {ate}")
    if not (slam.n_photo_fits >= 1 and err_est < 0.6 * err_id and corner < centre):
        failures.append(f"{tag}: {slam.n_photo_fits} fits, response rmse {err_est}, vignette "
                        f"corner {corner} centre {centre}")
    if launches != n or plain != 0:
        failures.append(f"{tag}: pyramid launches {launches} for {n} frames, plain {plain}")
    return dict(kf_frames=kfs, launches=launches)


def phase_dataset(card):
    """Sequences from disk (phase 15): two fixtures rendered through real
    lenses at their sensors' sizes, (a) EuRoC 752x480 RadTan and (b) TUM
    monoVO 1280x1024 FOV with a gamma 0.7 response, a vignette and
    exposures, both cropped to 640x480; (a) through run_sequence's dataset
    branch with loop closure, the metrics stream, debug PNGs and the live
    map over HTTP, then the PLY export and the TUM trajectory scored against
    the ground truth; (b) through run_sequence (corrected, then remapped):
    the sequential runs, held to the JAX package's keyframes and ATE; (c)
    eval_baseline.run_config config 2 on (b) and config 3 on (a), pipelined;
    (d) (b)'s fixture through run_sequence --online-calib, the loader's and
    the inline path, held to phase 12's calibration bars and to each other's
    keyframes."""
    import tempfile
    import urllib.request
    from hslam_tpu_torch.io import synthetic as syn
    from hslam_tpu_torch.io.trajectory import associate, evaluate_ate, read_tum, write_tum
    from hslam_tpu_torch.ops import pyramid as P
    from hslam_tpu_torch.tools import eval_baseline as EB
    from hslam_tpu_torch.tools import run_sequence as RS
    from hslam_tpu_torch.viz.export import window_pointcloud, write_ply
    t_phase = time.perf_counter()
    n = syn.DATASET_FRAMES
    failures, launches = [], 0
    with tempfile.TemporaryDirectory() as tmp:
        roots = {k: os.path.join(tmp, k) for k in ("euroc", "tum")}
        t0 = time.perf_counter()
        scene = syn.Scene(**syn.DATASET_SCENE)
        fx = {"euroc": syn.write_euroc(roots["euroc"], scene, n),
              "tum": syn.write_tum(roots["tum"], scene, n)}
        log(f"[dataset] {card} | wrote both fixtures in {time.perf_counter() - t0:.2f} s")
        for k, info in fx.items():
            cam = info["camera"]
            same = info["sha256"] == JAX_CPU_DATASET[k]["sha256"]
            shape, gap, lgap, lok = _correction_gaps(roots[k])
            log(f"[dataset] {k}: {n} frames {cam.model} {cam.in_size} -> {cam.out_size}, "
                f"out_K fx {cam.out_K[0, 0]:.3f} fy {cam.out_K[1, 1]:.3f}; frames as the JAX "
                f"reference's: {same}; correct+remap of a {shape[1]}x{shape[0]} frame, card "
                f"against CPU: max |diff| {gap:.3g} (tolerance 1e-4); the loader's {n} frames "
                f"against FrameCorrector on the card: max |diff| {lgap:.3g} (rtol "
                f"{LOADER_RTOL}, atol {LOADER_ATOL}: {'within' if lok else 'OUTSIDE'})")
            if not gap <= 1e-4:
                failures.append(f"{k}: correct+remap card vs CPU {gap}")
            if not lok:
                failures.append(f"{k}: loader frames vs FrameCorrector on the card {lgap}")

        def gt_file(k):
            path = os.path.join(tmp, f"gt_{k}.txt")
            write_tum(path, fx[k]["timestamps"], fx[k]["poses"])
            return path

        def sequential(k, extra):
            nonlocal launches
            out = os.path.join(tmp, f"traj_{k}.txt")
            P.kernel_launches = 0
            P.plain_calls = 0
            res = RS.run(RS.parse_args(["--dataset", roots[k], "--out", out] + extra))
            slam, ref = res.system, JAX_CPU_DATASET[k]
            launches += P.kernel_launches
            gt = gt_file(k)
            ate = evaluate_ate(gt, out)
            matched = len(associate(read_tum(gt)[0], read_tum(out)[0]))
            valid = sum(s.pose_valid for s in slam.shells)
            kfs = [s.id for s in slam.shells if s.is_kf]
            bar = max(1.5 * ref["ate"], 0.02)
            tag = ("a" if k == "euroc" else "b") + (", inline" if "--no-prefetch" in extra else "")
            log(f"[dataset] ({tag}) {k} sequential: {card} | "
                f"{res.n_frames} frames in {res.seconds:.2f} s, fps {res.n_frames / res.seconds:.2f}"
                f"; per frame {res.times.summary()}")
            log(f"[dataset] ({tag}) {k}: valid {valid}/{n} lost "
                f"{slam.is_lost} keyframes {len(kfs)} at {kfs} (JAX CPU {ref['kf_frames']}); "
                f"gt matched {matched}; ATE {ate:.6f} (bar {bar:.4f}, JAX CPU {ref['ate']:.6f}); "
                f"loops {slam.n_loops_closed}; pyramid launches {P.kernel_launches} plain "
                f"{P.plain_calls}")
            if (valid != n or slam.is_lost or len(kfs) < 3
                    or abs(len(kfs) - len(ref["kf_frames"])) > 1 or matched < 55
                    or not ate <= bar):
                failures.append(f"{k} sequential: valid {valid} keyframes {len(kfs)} "
                                f"matched {matched} ATE {ate}")
            if P.kernel_launches != res.n_frames or P.plain_calls != 0:
                failures.append(f"{k} sequential: pyramid launches {P.kernel_launches} for "
                                f"{res.n_frames} frames, plain {P.plain_calls}")
            return res

        # (a) EuRoC through run_sequence with everything on
        metrics, viz = os.path.join(tmp, "metrics.jsonl"), os.path.join(tmp, "viz")
        res = sequential("euroc", ["--loop-closure", "--metrics", metrics, "--viz-dir", viz,
                                   "--view3d", "--view3d-port", "0"])
        try:
            with urllib.request.urlopen(res.viewer.url + "/data?from=0", timeout=60) as r:
                served = json.loads(r.read())
        finally:
            res.viewer.stop()
        counts = {t: sum(x["t"] == t for x in served["records"]) for t in ("frame", "kf", "map")}
        xyz, col = window_pointcloud(res.system.window, res.system.calib)
        ply = os.path.join(tmp, "map.ply")
        write_ply(ply, xyz, col)
        with open(ply) as f:
            ply_lines = sum(1 for _ in f)
        pngs = os.listdir(viz)
        log(f"[dataset] (a) served over HTTP: {counts} ({len(json.dumps(served))} B); window "
            f"cloud {len(xyz)} points -> PLY of {ply_lines} lines; debug PNGs {len(pngs)}")
        if min(counts.values()) == 0 or len(xyz) == 0 or ply_lines != len(xyz) + 10 or not pngs:
            failures.append(f"(a) viewer records {counts}, cloud {len(xyz)}, PNGs {len(pngs)}")
        # (b) TUM monoVO, photometrically corrected then remapped
        sequential("tum", [])
        # (d) TUM monoVO with --online-calib: the frames only remapped, the
        # system fits response, vignette and exposures; through the loader,
        # then inline
        online = [_online_calib_run(card, roots["tum"], gt_file("tum"), tmp, extra, failures)
                  for extra in ([], ["--no-prefetch"])]
        launches += sum(r["launches"] for r in online)
        if online[0]["kf_frames"] != online[1]["kf_frames"]:
            failures.append(f"(d) the loader and inline runs keyframe {online[0]['kf_frames']} "
                            f"and {online[1]['kf_frames']}")
        # (a) once more, with the same flags, on the inline path (decode
        # here, correction on the card, the round trip): its per-frame times
        # and fps beside the loader's
        inline = sequential("euroc", [
            "--loop-closure", "--metrics", os.path.join(tmp, "metrics_inline.jsonl"),
            "--viz-dir", os.path.join(tmp, "viz_inline"), "--view3d", "--view3d-port", "0",
            "--no-prefetch"])
        inline.viewer.stop()
        med = lambda xs: float(np.median(xs))  # noqa: E731
        t_a, t_i = res.times, inline.times
        log(f"[dataset] (a) euroc, loader against inline: {card} | fps "
            f"{res.n_frames / res.seconds:.2f} against {inline.n_frames / inline.seconds:.2f}; "
            f"p50 ms the loader's wait {med(t_a.wait):.2f} against decode + correct+remap + "
            f"round trip {med(t_i.decode) + med(t_i.correct) + med(t_i.round_trip):.2f}; "
            f"process_frame {med(t_a.process):.2f} against {med(t_i.process):.2f}")
        # (c) eval_baseline, pipelined
        for cid, k in ((2, "tum"), (3, "euroc")):
            P.kernel_launches = 0
            P.plain_calls = 0
            r = EB.run_config(roots[k], cid)
            launches += P.kernel_launches
            ref = JAX_CPU_DATASET[f"config{cid}"]
            bar = max(1.5 * ref["ate_max"], 0.02)
            log(f"[dataset] (c) config {cid} on {k}, pipelined: {card} | {json.dumps(r)}")
            log(f"[dataset] (c) config {cid}: keyframes {r['n_keyframes']} (JAX CPU "
                f"{ref['keyframes']}), ATE {r['ate_rmse']} (bar {bar:.4f}, JAX CPU "
                f"{ref['ate_min']:.6f}..{ref['ate_max']:.6f} over three runs); pyramid launches "
                f"{P.kernel_launches} plain {P.plain_calls}")
            if (not r["initialized"] or r["n_valid_poses"] != n or r["n_keyframes"] < 3
                    or r["gt_matched_frames"] < 55 or r["ate_rmse"] is None
                    or not r["ate_rmse"] <= bar):
                failures.append(f"config {cid}: {r}")
            if P.kernel_launches != n + r["n_track_retries"] or P.plain_calls != 0:
                failures.append(f"config {cid}: pyramid launches {P.kernel_launches}, plain "
                                f"{P.plain_calls}")
    log(f"[dataset] phase 15 took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("dataset: " + "; ".join(failures))
    return launches


def phase_tools(card):
    """The port's counterparts of scripts/ (phase 16), each as a user calls
    it, on the card: (a) drive_synthetic's three checks; (b) profile_kf at
    640x480 with a torch.profiler trace; (c) train_vocab --diverse 4 --views
    3 --k 8 --levels 2 at 480x640, the file loaded into SLAMSystem and a
    frame's descriptors quantized; (d) make_synthetic_dataset at its
    defaults on the card, against the same tool on the CPU, then
    run_sequence --loop-closure through the loader on the CPU's frames,
    held to the JAX package's ATE on them (JAX_CPU_SYNTH); (e)
    loop_debug over phase 11's 326 frames through the pipelined entry with
    the mapping thread and the loop-closure worker, held to the JAX
    package's pipelined outcome (JAX_CPU_LOOP_DEBUG). Pyramid launches are
    counted per tool, plain calls must stay 0."""
    import hashlib
    import tempfile
    from pathlib import Path

    import cv2

    from hslam_tpu_torch.io.trajectory import evaluate_ate
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import bow as bow_ops
    from hslam_tpu_torch.ops import features as ft
    from hslam_tpu_torch.ops import pyramid as P
    from hslam_tpu_torch.tools import drive_synthetic as DS
    from hslam_tpu_torch.tools import loop_debug as LD
    from hslam_tpu_torch.tools import make_synthetic_dataset as MSD
    from hslam_tpu_torch.tools import profile_kf as PK
    from hslam_tpu_torch.tools import run_sequence as RS
    from hslam_tpu_torch.tools import train_vocab as TV
    t_phase = time.perf_counter()
    failures, launches, secs = [], 0, {}

    def counted(name, fn, want_min):
        """fn() with the pyramid counts set to 0 just before it and read
        just after; launches below `want_min` or any plain call fail."""
        nonlocal launches
        torch.cuda.synchronize()
        P.kernel_launches = 0
        P.plain_calls = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches += P.kernel_launches
        log(f"[tools] ({name}) {secs[name]:.1f} s; pyramid launches {P.kernel_launches} "
            f"plain {P.plain_calls}")
        if P.kernel_launches < want_min or P.plain_calls != 0:
            failures.append(f"{name}: pyramid launches {P.kernel_launches} (at least "
                            f"{want_min}), plain {P.plain_calls}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        # (a) drive_synthetic
        d = counted("a", lambda: DS.run("cuda"), 3)
        log(f"[tools] (a) drive_synthetic: {card} | pose error {d['err0']:.4f} -> "
            f"{d['err1']:.6f}, BA rmse {d['ba_rmse']:.4f}, track {d['track_ms']:.1f} ms, "
            f"BA {d['ba_ms']:.1f} ms")

        # (b) profile_kf, 640x480, bench.py's capacities, a trace
        def profile():
            slam, frames = PK.warm_system(26, "cuda", PK.BENCH_CFG)
            try:
                log(f"[tools] (b) profile_kf warmed: {slam.next_kf_id} keyframes, "
                    f"initialized={slam.initialized}")
                return PK.profile(slam, frames[-1], 10, os.path.join(tmp, "trace"))
            finally:
                slam.close()
        prof = counted("b", profile, 26)
        log(f"[tools] (b) profile_kf: {card} | median of 10, ms (device span, host):")
        for name, dev_ms, host_ms in prof["rows"]:
            log(f"[tools] (b)   {name:40s} {dev_ms:10.3f} {host_ms:10.3f}")
        size = os.path.getsize(prof["trace_file"]) if prof["trace_file"] else 0
        log(f"[tools] (b) state unchanged: {prof['state_unchanged']}; trace {size} B")
        if (len(prof["rows"]) != 8 or not prof["state_unchanged"] or size == 0
                or not all(r[1] is not None and np.isfinite(r[1]) and r[1] > 0
                           and np.isfinite(r[2]) and r[2] > 0 for r in prof["rows"])):
            failures.append(f"profile_kf: {prof}")

        # (c) train_vocab on the card, then loaded by the system
        vocab = os.path.join(tmp, "vocab.npz")
        voc = counted("c", lambda: TV.run(TV.parse_args(
            ["--diverse", "4", "--views", "3", "--k", "8", "--levels", "2", "--out", vocab])), 0)
        slam = SLAMSystem(320.0, 320.0, 319.5, 239.5, 640, 480, _hybrid_cfg(), vocab_path=vocab)
        try:
            img = next(TV.diverse_scene_images(1, 1, seed=9, device="cuda"))[1]
            _, _, _, _, desc, valid = ft.extract_multiscale(
                torch.as_tensor(img, dtype=torch.float32, device="cuda"), 4, 512, 10.0)
            words = bow_ops.quantize(slam.loop_closer.vocab, desc, valid)[valid]
            n_w = slam.loop_closer.vocab.n_words
        finally:
            slam.close()
        in_range = bool(((words >= 0) & (words < n_w)).all())
        log(f"[tools] (c) train_vocab: {card} | {voc.n_words} words, {int((voc.idf > 0).sum())} "
            f"observed; loaded by SLAMSystem ({n_w} words): {int(valid.sum())} descriptors of a "
            f"480x640 view quantized to {len(torch.unique(words))} distinct words")
        if voc.n_words != 64 or n_w != 64 or not in_range or int(valid.sum()) == 0:
            failures.append("train_vocab: the vocabulary did not load or quantize")

        # (d) make_synthetic_dataset at its defaults on the card, and on the
        # CPU (the frames of the JAX record: the card's float32 sin and pow
        # round a few pixels the other way); run_sequence on the latter
        on_card, root = os.path.join(tmp, "synth_card"), os.path.join(tmp, "synth")
        out = os.path.join(tmp, "synth.txt")
        t0 = time.perf_counter()
        MSD.write_dataset(on_card)
        t_card = time.perf_counter() - t0
        MSD.write_dataset(root, device="cpu")
        digest, img_gap, n_diff = hashlib.sha256(), 0, 0
        for i in range(60):
            a, b = (cv2.imread(os.path.join(r, "images", f"{i:05d}.png"),
                               cv2.IMREAD_GRAYSCALE) for r in (root, on_card))
            digest.update(a.tobytes())
            img_gap = max(img_gap, int(np.abs(a.astype(int) - b.astype(int)).max()))
            n_diff += int((a != b).sum())
        same_files = all(
            Path(root, f).read_bytes() == Path(on_card, f).read_bytes()
            for f in ("camera.txt", "pcalib.txt", "times.txt", "groundtruth.txt", "vignette.png"))
        ref = JAX_CPU_SYNTH
        same = digest.hexdigest() == ref["sha256"]
        log(f"[tools] (d) make_synthetic_dataset: {card} | 60 frames 320x240 in {t_card:.2f} s; "
            f"against the CPU's: text files, vignette and ground truth identical {same_files}, "
            f"images within {img_gap} level ({n_diff} pixels differ); the CPU's frames as the "
            f"JAX reference's: {same}")
        if not same_files or img_gap > 1 or not same:
            failures.append(f"make_synthetic_dataset: files {same_files}, image gap {img_gap}, "
                            f"frames as the record's {same}")
        res = counted("d", lambda: RS.run(RS.parse_args(
            ["--dataset", root, "--out", out, "--loop-closure"])), 60)
        slam = res.system
        kfs = [s.id for s in slam.shells if s.is_kf]
        valid_n = sum(s.pose_valid for s in slam.shells)
        ate = evaluate_ate(os.path.join(root, "groundtruth.txt"), out)
        bar = max(1.5 * ref["ate"], 0.02)
        log(f"[tools] (d) run_sequence on it: {res.n_frames} frames in {res.seconds:.2f} s, fps "
            f"{res.n_frames / res.seconds:.2f}; per frame {res.times.summary()}")
        log(f"[tools] (d) valid {valid_n}/60 lost {slam.is_lost} keyframes {len(kfs)} at {kfs} "
            f"(JAX CPU {ref['kf_frames']}); ATE {ate:.6f} (bar {bar:.4f}, JAX CPU "
            f"{ref['ate']:.6f})")
        # the keyframe count is reported, not held to the JAX package's: on
        # this sequence +-1 on 10 random pixels a frame moves the port's CPU
        # run from 6 keyframes (ATE 0.073) to 13 (0.050) or 3 (0.032)
        if valid_n != 60 or slam.is_lost or len(kfs) < 3 or not ate <= bar:
            failures.append(f"synthetic dataset: valid {valid_n} keyframes {kfs} ATE {ate}")

    # (e) loop_debug over phase 11's sequence, pipelined
    ld = counted("e", lambda: LD.run(n_arc=SEQ_FRAMES), 326)
    ref = JAX_CPU_LOOP_DEBUG
    bar = max(1.5 * ref["ate_max"], 0.02)
    verified = ld["loops_closed"] + ld["verified_insignificant"]
    log(f"[tools] (e) loop_debug: {card} | {ld['frames']} frames pipelined: arc fps "
        f"{ld['fps_arc']:.2f}, loop fps {ld['fps_loop']:.2f}; keyframes {ld['keyframes']} "
        f"(JAX CPU {ref['keyframes'][0]}-{ref['keyframes'][1]}), valid {ld['valid']} "
        f"(JAX CPU {ref['valid']}), ATE {ld['ate']:.6f} (bar {bar:.4f}, JAX CPU "
        f"{ref['ate_min']:.6f}..{ref['ate_max']:.6f}); loops closed {ld['loops_closed']} + "
        f"verified below significance {ld['verified_insignificant']} (JAX CPU at least "
        f"{ref['verified_min']} in every rerun); relocs {ld['relocs']}, retries "
        f"{ld['track_retries']}; lc_detect_ms p50 {ld['lc_detect_p50']:.1f} p95 "
        f"{ld['lc_detect_p95']:.1f} (n={ld['n_detect']}); entries {ld['lc_entries']}, "
        f"run_scale {ld['run_scale']:.4f}; gates {ld['gates']}")
    if ld["valid"] != ld["frames"] or ld["frames"] != 326 or ld["lost"] or not ld["ate"] <= bar:
        failures.append(f"loop_debug: valid {ld['valid']}/{ld['frames']} ATE {ld['ate']}")
    if ref["verified_min"] >= 1 and verified < 1:
        failures.append("loop_debug: no revisit verified, every JAX rerun verifies one")
    log(f"[tools] seconds by tool {json.dumps({k: round(v, 1) for k, v in secs.items()})}; "
        f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("tools: " + "; ".join(failures))
    return launches


def phase_longrun(card):
    """tests/test_longrun.py on the card: its 500 frames rendered here from
    the port's copy of tests/test_system.py's scene (io/synthetic), through
    the sequential system with its Config and loop closure on the shipped
    vocabulary; its bars: never lost, initialized, more than 50 keyframes
    and 50 loop-closure entries, ATE over every frame under 0.20."""
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.io import synthetic as syn
    from hslam_tpu_torch.io.trajectory import ate_rmse
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops import pyramid as P
    t0 = time.perf_counter()
    frames, stamps, gt = syn.longrun_frames(device="cuda")
    H, W, F = syn.SWEEP_H, syn.SWEEP_W, syn.SWEEP_F
    log(f"[longrun] {card} | {len(frames)} frames of {H}x{W} rendered on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    slam = SLAMSystem(F, F, W / 2 - 0.5, H / 2 - 0.5, W, H, Config(**LONGRUN_CFG))
    lost, frame_ms = [], []
    torch.cuda.synchronize()
    P.kernel_launches = 0
    P.plain_calls = 0
    t_all = time.perf_counter()
    for i, (f, ts) in enumerate(zip(frames, stamps)):
        t1 = time.perf_counter()
        slam.process_frame(f, ts)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t1))
        if slam.is_lost:
            lost.append(i)
    wall = time.perf_counter() - t_all
    launches, plain = P.kernel_launches, P.plain_calls
    slam.close()
    n = len(frames)
    est = np.array([s.cam_to_world[:3, 3] for s in slam.shells])
    ate = float(ate_rmse(np.array([g[:3, 3] for g in gt]), est))
    lcl, ref = slam.loop_closer, JAX_CPU_LONGRUN
    valid = sum(s.pose_valid for s in slam.shells)
    det = sorted(slam.lc_detect_ms)
    log(f"[longrun] {card} | {n} frames sequential in {wall:.2f} s, fps {n / wall:.2f}; "
        f"process_frame ms p50 {np.percentile(frame_ms, 50):.2f} p95 "
        f"{np.percentile(frame_ms, 95):.2f}; frames lost {len(lost)} {lost[:5]}; valid "
        f"{valid}/{n} (JAX CPU {ref['valid']}); keyframes {slam.next_kf_id} (JAX CPU "
        f"{ref['keyframes']}; bar > 50); loop-closure entries {len(lcl.entries)} (JAX CPU "
        f"{ref['entries']}; bar > 50); loops closed {slam.n_loops_closed} + verified below "
        f"significance {lcl.n_verified_insignificant} (JAX CPU {ref['loops_closed']} + "
        f"{ref['verified_insignificant']}); relocs {slam.n_relocs}; ATE {ate:.6f} (bar 0.20, "
        f"JAX CPU {ref['ate']:.6f}); detect ms p50 {det[len(det) // 2] if det else float('nan'):.1f}; "
        f"pyramid launches {launches} (= {n} + {slam.n_track_retries} retries) plain {plain}")
    log(f"[longrun] keyframes at frames {[s.id for s in slam.shells if s.is_kf][:12]} ...")
    failures = []
    if lost or not slam.initialized:
        failures.append(f"lost at frames {lost[:5]}, initialized {slam.initialized}")
    if not slam.next_kf_id > 50 or not len(lcl.entries) > 50:
        failures.append(f"{slam.next_kf_id} keyframes, {len(lcl.entries)} loop-closure entries")
    if not (np.isfinite(ate) and ate < 0.20):
        failures.append(f"ATE {ate}")
    if launches != n + slam.n_track_retries or plain != 0:
        failures.append(f"pyramid launches {launches} for {n} frames, plain {plain}")
    if failures:
        raise AssertionError("longrun: " + "; ".join(failures))
    return launches


def main():
    t_start = time.perf_counter()
    card = phase_environment()
    # (phase, takes the card's name, returns the pyramid launches of its runs)
    phases = [(phase_build, False, False), (phase_kernel, False, False),
              (phase_parity, False, False), (phase_main_path, True, True),
              (phase_hybrid_parity, False, False), (phase_pipelined, True, True),
              (phase_relocalization, True, True), (phase_loop_modules, True, False),
              (phase_loop_closer, True, False), (phase_loop_sequence, True, True),
              (phase_photocal, True, True), (phase_checkpoint, True, True),
              (phase_distributed, True, True), (phase_dataset, True, True),
              (phase_tools, True, True), (phase_longrun, True, True)]
    launches, secs = 0, {"environment": time.perf_counter() - t_start}
    for fn, takes_card, counts in phases:
        t0 = time.perf_counter()
        out = fn(card) if takes_card else fn()
        secs[fn.__name__[len("phase_"):]] = time.perf_counter() - t0
        if fn is phase_build:
            ptxas = out
        elif fn is phase_kernel:
            kernel = out
            tracker = kernel.pop("tracker")
        elif counts:
            launches += out
    log(f"[time] seconds by phase (1-17) {json.dumps({k: round(v, 1) for k, v in secs.items()})}"
        f"; whole script {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "pyramid_fused", "route": "cuda",
        "source": "hslam_tpu_torch/csrc/pyramid.cu",
        "replaces": "hslam_tpu/ops/pallas_kernels.py:38",
        "launches": launches, **kernel}, {
        "name": "track_coarse", "route": "cuda",
        "source": "hslam_tpu_torch/csrc/tracker.cu",
        "replaces": None, "launches": RESULTS["track_main"]["launches"],
        "plain_calls": RESULTS["track_main"]["plain"],
        "frames": RESULTS["track_main"]["frames"], "ptxas": ptxas, **tracker}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
