#!/usr/bin/env python3
"""One run of one cell of the port's benchmark (BENCHMARK.json).

    python3 slambench/run.py --workload euroc_mh.laps --seed 7 --seconds 45 --trace 0

A run, from the root of a checkout, on one card:
1. Set-up (`setup_s`, from the process's start): keep to as many host
   cores as the entry has threads (`pin_cores`), import and init the card,
   build the pyramid kernel (hslam_tpu_torch/_build/, inside the checkout),
   render the cell's raw sensor frames on the card from the seed and bring
   them to the host as uint8, build the system, and run the bootstrap and
   the configuration's warm-up frames through the window's own path.
2. The window: for --seconds, frames go in unpaced, in a closed loop: each
   raw frame is rectified on the card by the program (ops/undistort's
   remap with io/calib_io's table from the configuration's camera.txt),
   brought back to the host, and handed to the configuration's entry
   (`process_frame_pipelined` or `process_frame`) with its timestamp and
   exposure. `fps` is frames completed in the window over its length (the
   card synchronised at its close); `frame_ms_p95` is the 95th percentile,
   over those frames, of the time from a frame's hand-over to the return of
   the call that gave back its pose.
3. After the window: the in-flight frames complete, the peak of device
   memory is read, the system is closed, and the captured answers are held
   against the plain reference by the judges the configuration's `limits`
   choose (judge.py, judges/*.py). The last line of standard output is the
   result; the numbers compared, each beside its limit, are the last lines
   of standard error and the result's last key.
With --trace 1 the window also records the spans, counters and latency
records the cell's per-layer metrics read (metrics/*.py), and profiles a
stretch of its last frames; the result then holds those metrics. Where one
of them reads the program's own spans and counters, the program's tracer
is on from just before the system is built until the window closes.

A run without a CUDA card, or whose `limits` name a key that no judge or
more than one reads, exits non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FORBIDDEN = ("jax", "jaxlib", "flax", "hslam_tpu")
# the profiled stretch: PROFILE_FRAMES frames from PROFILE_LAST_S seconds
# before the window closes. Once started, the profiler slows the host for
# the rest of the process, so it comes last and the spans leave it out;
# starting it takes several seconds of the window.
PROFILE_LAST_S = 22.0
PROFILE_FRAMES = 20
MAX_INIT_FRAMES = 120    # a bootstrap that takes longer fails the run
# the entry's busy threads: tracking; pipelined, also mapping and loop closure
ENTRY_THREADS = {"sequential": 1, "pipelined": 3}


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (hslam_tpu_torch is the port, and allowed)."""
    mods = sys.modules if modules is None else modules
    return sorted({m for m in mods if m.split(".")[0] in FORBIDDEN})


def pin_cores(entry: str) -> list:
    """Keep the process, and every thread it starts later, on as many cores
    as the entry has busy threads, the last ones it may use. The program's
    host work is one busy Python thread an entry thread; left free to move
    over cores that the machine's other load shares, it ran 4-8% slower
    and spread wider. Call it before torch is imported."""
    allowed = sorted(os.sched_getaffinity(0))
    n = ENTRY_THREADS.get(entry, len(allowed))
    if len(allowed) > n:
        os.sched_setaffinity(0, allowed[-n:])
    return sorted(os.sched_getaffinity(0))


class RunFailed(RuntimeError):
    pass


def _card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False, root: str = HERE,
             log=lambda m: print(m, file=sys.stderr, flush=True)) -> dict:
    """The run's result (see the module's docstring) as a dict."""
    import numpy as np
    import torch

    from slambench import judge, program, registry, scene, stats, tracing
    from slambench.reference import lens as RL

    cfg = registry.config(cell["config"], root)
    traffic = registry.traffic(cell["traffic"], root)
    try:
        panel = judge.Panel(cfg["limits"], root)
    except judge.BadLimits as e:
        raise RunFailed(str(e)) from None
    metric_defs = registry.per_layer(bench, cell["name"]) if trace else []
    metrics = {m["name"]: registry.metric_module(m["name"], root) for m in metric_defs}
    wraps, counters, deques, need_prof, need_program = {}, set(), set(), False, False
    for mod in metrics.values():
        src = mod.SOURCE
        for name, targets in src.get("wrap", {}).items():
            for t in targets:
                wraps[t] = name
        counters.update(src.get("counter", ()))
        deques.update(src.get("deque", ()))
        need_prof |= bool(src.get("profiler"))
        need_program |= "program" in src
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    from hslam_tpu_torch import _cuda
    from hslam_tpu_torch.config import Config
    from hslam_tpu_torch.io.calib_io import parse_camera_txt
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.ops.undistort import remap_image

    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=dev)
        _cuda.load("pyramid")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "camera.txt")
        with open(path, "w") as f:
            f.write(cfg["camera_txt"])
        cam = parse_camera_txt(path)
    remap = torch.as_tensor(cam.remap, device=dev)
    K = cam.out_K
    W, H = cam.out_size

    rate = float(cfg["rate_hz"])
    n_line = 0
    if traffic["path"] == "line":
        n_line = MAX_INIT_FRAMES + int(cfg["warmup_frames"]) + int(
            math.ceil(float(traffic["rate_factor"]) * rate * seconds))
    t_render = time.perf_counter()
    stream = scene.render_stream(cfg, traffic, seed, n_line, dev)
    n_stream = stream.frames.shape[0]
    log(f"[setup] {cell['name']} seed {seed}: imports, card and kernel "
        f"{t_render - T_START:.3f} s; {n_stream} frames of {tuple(stream.frames.shape[1:])} "
        f"rendered in {time.perf_counter() - t_render:.3f} s, period {stream.period}, "
        f"laps in the order {stream.order}")

    def slot(j):
        try:
            return stream.slot(j)
        except IndexError as e:
            raise RunFailed(str(e)) from None

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sysc = cfg["system"]
    config = Config(**cfg["capacities"], **{k: tuple(v) if isinstance(v, list) else v
                                            for k, v in cfg["tracker"].items()})
    recent = []          # the last frames handed over: (index, rectified host frame)
    handed = {}          # frame index -> hand-over time
    tracing_on = [False]
    spans = tracing.Spans()

    def feed(j):
        """Frame j through the window's path; returns (shell or None, the
        call's return time)."""
        s = slot(j)
        if tracing_on[0]:
            sync()
        t_h = time.perf_counter()
        rect = remap_image(stream.frames[s].to(dev), remap).cpu().numpy()
        t_r = time.perf_counter()
        recent.append((j, rect))
        del recent[:-3]
        handed[j] = t_h
        out = entry(rect, j / rate, float(stream.exposures[s]))
        t_done = time.perf_counter()
        if tracing_on[0]:
            spans.add("rectify", t_h, t_r)
            spans.add("entry", t_r, t_done)
        return out, t_done

    slam = None
    if need_program:
        program.start()
    try:
        slam = SLAMSystem(K[0, 0], K[1, 1], K[0, 2], K[1, 2], W, H, config,
                          enable_loop_closure=sysc["enable_loop_closure"],
                          sequential=cfg["entry"] == "sequential",
                          online_photo_calib=sysc["online_photo_calib"],
                          photo_calib_every=sysc["photo_calib_every"], device=dev)
        entry = (slam.process_frame if cfg["entry"] == "sequential"
                 else slam.process_frame_pipelined)
        ctx = judge.Context(seed, slam, cfg["entry"] == "sequential", rate, recent)
        panel.install("run", ctx)

        # set-up: the bootstrap, then the warm-up frames
        t_boot = time.perf_counter()
        j = 0
        while not slam.initialized:
            if j >= MAX_INIT_FRAMES:
                raise RunFailed(f"not initialized after {j} frames")
            feed(j)
            j += 1
        for _ in range(int(cfg["warmup_frames"])):
            feed(j)
            j += 1
        sync()
        t_init = j
        setup_s = time.perf_counter() - T_START
        log(f"[setup] initialized at frame {t_init - int(cfg['warmup_frames'])}; bootstrap and "
            f"warm-up {time.perf_counter() - t_boot:.3f} s; set-up {setup_s:.3f} s "
            f"(nvcc {_cuda.build_seconds.get('pyramid', 0.0):.3f} s)")

        # the window
        panel.install("window", ctx)
        prof = tracing.Profiler() if (need_prof and on_card) else None
        completed = []       # (frame index, hand-over, return)
        failed_ids = set()
        first = t_init
        with contextlib.ExitStack() as stack:
            if trace:
                stack.enter_context(tracing.wrapped(wraps, spans, sync))
                got = stack.enter_context(tracing.unbounded(slam, sorted(deques)))
                tracing_on[0] = True
            c0 = {c: getattr(slam, c) for c in counters}
            t0 = time.perf_counter()
            try:
                while time.perf_counter() - t0 < seconds:
                    if prof is not None and prof.t0 is None and (
                            time.perf_counter() - t0 >= seconds - PROFILE_LAST_S):
                        prof.start()
                        p_first = j
                    if prof is not None and prof.t0 is not None and j == p_first + PROFILE_FRAMES:
                        prof.stop()
                    lost_before = slam.is_lost
                    out, t_done = feed(j)
                    j += 1
                    if out is not None:
                        k = int(round(out.timestamp * rate))
                        completed.append((k, handed[k], t_done))
                        if k >= first and (lost_before or slam.is_lost):
                            failed_ids.add(k)
                sync()
                t_end = time.perf_counter()
            finally:
                if prof is not None:
                    prof.stop()
                tracing_on[0] = False
                program.stop()
            c1 = {c: getattr(slam, c) for c in counters}
        attempted = j - first
        in_window = [c for c in completed if c[0] >= first]
        if not in_window:
            raise RunFailed("no frame completed in the window")
        e2e = stats.window_metrics([c[1] for c in in_window], [c[2] for c in in_window], t0, t_end)
        log(f"[window] {attempted} frames handed over, {e2e['n']} completed in "
            f"{t_end - t0:.3f} s; frame_ms_p95 over {e2e['n']} samples")

        # after the window: the in-flight frames complete; then the peak
        if cfg["entry"] != "sequential":
            slam.flush_pipeline()
            slam.finish()
        sync()
        for s in slam.shells:
            k = int(round(s.timestamp * rate))
            if k >= first and (not s.pose_valid or not np.all(np.isfinite(s.cam_to_world))):
                failed_ids.add(k)
        failed = len(failed_ids)
        mem_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
        counts = dict(keyframes=slam.next_kf_id, loops_closed=slam.n_loops_closed,
                      relocs=slam.n_relocs, retries=slam.n_track_retries,
                      skipped=slam.n_frames_skipped, photo_fits=slam.n_photo_fits)
        traj = [(int(round(s.timestamp * rate)), s.cam_to_world[:3, 3].copy())
                for s in slam.shells if s.pose_valid]
    except BaseException:
        # a failed run still stops the system's threads before it ends
        if slam is not None:
            with contextlib.suppress(Exception):
                slam.close()
        raise
    finally:
        panel.remove()
        program.stop()
    slam.close()
    del slam, entry
    if on_card:
        torch.cuda.empty_cache()

    # the device trace, then the judgement
    dtrace = prof.reduce(spans) if prof is not None else None
    lens = RL.parse_camera_txt(cfg["camera_txt"])
    t_judge = time.perf_counter()
    inputs = judge.Inputs(lambda k: stream.frames[slot(k)],
                          lambda k: float(stream.exposures[slot(k)]), lens, cfg, dev)
    judged = panel.judge(inputs, control)
    correct, checks = panel.verdict(judged)
    log(f"[info] {counts}; judged {panel.merged(judged, 'counts')} in "
        f"{time.perf_counter() - t_judge:.3f} s; ATE (not compared) {_ate(traj, stream, slot):.6f}")
    for name in panel.report_order():
        for row in judged[name].rows:
            log(f"[judge] {name} {row}")
    if control:
        log(f"[control] {json.dumps(panel.merged(judged, 'control'))}")

    result = {"correct": bool(correct), "attempted": attempted, "failed": failed}
    if trace:
        ctx = TraceData(spans, c0, c1, got, dtrace, e2e, attempted, cfg, cam,
                        prof.t0 if dtrace is not None else math.inf)
        vals = {}
        for m in metric_defs:
            v = metrics[m["name"]].read(ctx)
            if v is not None:
                vals[m["name"]] = {"value": v, "unit": metrics[m["name"]].UNIT}
        result["metrics"] = vals
    else:
        measured = dict(fps=e2e["fps"], frame_ms_p95=e2e["frame_ms_p95"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                             for m in registry.end_to_end(bench, cell["name"])}
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": mem_peak,
    }
    if trace and dtrace is not None:
        result["device"].update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in dtrace.top_ops],
                               "idle_gaps": [list(x) for x in dtrace.gaps]}
    if control:
        result["control"] = panel.merged(judged, "control")
    result["checks"] = checks
    return result


class TraceData:
    """What a per-layer metric's reader may read (metrics/*.py)."""

    def __init__(self, spans, c0, c1, deques, device, e2e, attempted, cfg, cam, profiled_from):
        self.spans, self.c0, self.c1, self.deques = spans, c0, c1, deques
        self.device, self.e2e, self.attempted = device, e2e, attempted
        self.cfg, self.cam, self.profiled_from = cfg, cam, profiled_from

    @property
    def frames(self) -> int:
        """Frames completed in the window."""
        return self.e2e["n"]

    def span_ms(self, name):
        """The span's times in ms, up to the profiled stretch (the profiler
        slows the host from its start on)."""
        return [1e3 * (s.t1 - s.t0) for s in self.spans.of(name) if s.t1 < self.profiled_from]

    def counter_delta(self, name):
        return self.c1[name] - self.c0[name]


def _ate(traj, stream, slot) -> float:
    """Sim3-aligned RMSE of the valid camera centres against the rendered
    path (reported, not compared)."""
    import numpy as np
    if len(traj) < 3:
        return float("nan")
    est = np.stack([p for _, p in traj])
    gt = np.stack([stream.centres[slot(k)] for k, _ in traj])
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(G.T @ E)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max((E * E).sum(), 1e-300)
    res = gt - (s * (R @ E.T).T + mu_g)
    return float(np.sqrt((res * res).sum(1).mean()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control (the reference in bfloat16 in the "
                         "program's place); not part of the benchmark's runs")
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    from slambench import registry
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    cores = pin_cores(registry.config(cell["config"])["entry"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"slambench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"[card] {_card_line()}; host cores {cores}", file=sys.stderr, flush=True)
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                      control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"slambench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
