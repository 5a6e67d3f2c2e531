"""Per-phase times of the keyframe path (counterpart of scripts/profile_kf.py).

Usage:
    python -m hslam_tpu_torch.tools.profile_kf                 # per-phase times
    python -m hslam_tpu_torch.tools.profile_kf --trace DIR     # + a torch.profiler
                                                               #   chrome trace

Warms the real pipelined `SLAMSystem` (bench.py's capacities, 640x480, loop
closure off) over `--frames` frames of io/synthetic's arc, then times each
phase of the keyframe path from the system's live state: the pyramid,
`track_step`, the pixel selector, the indirect features, the epipolar trace
of all candidates, `ba_optimize` at cfg.max_opt_iterations, `map_cloud`
and the whole `kf_step`. Each phase gets two numbers, medians of `--reps`
calls after one warm call: the device span (CUDA events before and after
the call, synchronised; "not measured" on the CPU) and the host's wall
time to a synchronised device. The port is host-bound, so the device span
alone would mislead: it covers the gaps while the host launches.

The JAX script re-runs its keyframe step freely because JAX is functional;
here every call of `ba_optimize` and `kf_step` gets a clone of the state,
and the system's state is checked, tensor by tensor with torch.equal, to be
unchanged after all phases. `--trace DIR` replaces the JAX profiler trace:
three rounds of `track_step` + `ba_optimize` under torch.profiler, written
as DIR/profile_kf_trace.json.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.checkpoint import _named_leaves
from ..io.synthetic import Scene, make_sequence
from ..models import kf_step as KS
from ..models.optimizer import ba_optimize
from ..models.system import SLAMSystem, map_cloud

# bench.py's capacities (bench.py:238)
BENCH_CFG = Config(max_frames=8, max_points=2048, max_immature=2048, pyr_levels=6)


def _clone(tree):
    """A copy of a structure of NamedTuples, lists and tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_clone(x) for x in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(x) for x in tree)
    return tree


def state_leaves(slam: SLAMSystem) -> dict:
    """Every leaf (tensors, a few ints) of the system's map and tracking
    state, by name."""
    out = {}
    for prefix, tree in (("window", slam.window), ("imm", slam.imm), ("feats", slam.feats),
                         ("template", slam.template), ("calib", slam.calib)):
        out.update(_named_leaves(tree, prefix))
    return out


def time_phase(fn, reps: int, dev: torch.device, prepare=None) -> Tuple[Optional[float], float]:
    """(device span ms or None on the CPU, host ms): medians over `reps`
    calls after one warm call. `prepare()` makes the call's arguments,
    outside the timed region."""
    cuda = dev.type == "cuda"
    spans, hosts = [], []
    for r in range(reps + 1):
        args = prepare() if prepare is not None else ()
        if cuda:
            torch.cuda.synchronize(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        fn(*args)
        if cuda:
            ev[1].record()
            torch.cuda.synchronize(dev)
        host = 1e3 * (time.perf_counter() - t0)
        if r:
            hosts.append(host)
            if cuda:
                spans.append(ev[0].elapsed_time(ev[1]))
    return (float(np.median(spans)) if cuda else None), float(np.median(hosts))


def warm_system(n_frames: int, device, cfg: Config, size=(480, 640, 320.0)):
    """The pipelined system after `n_frames` frames of the arc (uint8)."""
    H, W, fx = size
    frames, _ = make_sequence(Scene(H, W, fx), n_frames)
    slam = SLAMSystem(fx, fx, W / 2 - 0.5, H / 2 - 0.5, W, H, cfg, sequential=False,
                      enable_loop_closure=False, device=device)
    try:
        for i, img in enumerate(frames):
            slam.process_frame_pipelined(img, i * 0.05)
        slam.flush_pipeline()
        slam.finish()
    except BaseException:
        slam.close()
        raise
    return slam, frames


def profile(slam: SLAMSystem, img: np.ndarray, reps: int = 10,
            trace: Optional[str] = None) -> dict:
    """Time each phase on `slam`'s state with the frame `img`. Returns the
    rows [(name, device ms or None, host ms)], whether the state is
    unchanged afterwards, and the trace file (or None)."""
    if not slam.initialized or slam.template is None:
        raise RuntimeError("profile_kf needs an initialized system with a tracking template")
    cfg, dev = slam.cfg, slam.device
    before = {k: _clone(v) for k, v in state_leaves(slam).items()}
    raw = torch.as_tensor(img).to(dev)
    pyr, grads = slam._pyramid(raw)
    with slam._shell_lock:
        ref_c2w = slam._f32(slam.shells[slam.ref_shell_id].cam_to_world)
        Tw = np.linalg.inv(slam.shells[-1].cam_to_world)
    R, t = slam._f32(Tw[:3, :3]), slam._f32(Tw[:3, 3])
    zero2, one = torch.zeros(2, device=dev), torch.ones((), device=dev)
    F = cfg.max_frames
    free = np.flatnonzero(~slam.window.frames.valid.cpu().numpy())
    slot = int(free[0]) if free.size else 0
    sel = slam._select_px(slam.selector_pot, pyr[0], grads,
                          int(cfg.desired_immature_density), 11)

    def track():
        return slam._track_step(raw, ref_c2w, ref_c2w, ref_c2w, False, zero2, 1.0, 1.0)

    def state():
        return (_clone(slam.window), _clone(slam.calib), _clone(slam.imm), _clone(slam.feats))

    def kf(window, calib, imm, feats):
        return KS.kf_step(window, calib, imm, feats, pyr, R, t, zero2, one, slot,
                          slam.next_kf_id, slam.ref_slot, np.zeros(F, bool),
                          float(slam.current_min_act_dist), cfg.max_opt_iterations, *sel, cfg)

    phases = [
        ("pyramid build", lambda: slam._pyramid(raw), None),
        ("track_step (fused frame tracking)", track, None),
        ("pixel selector", lambda: slam._select_px(
            slam.selector_pot, pyr[0], grads, int(cfg.desired_immature_density), 7), None),
        ("indirect features (FAST+rBRIEF)", lambda: KS.extract_feats(pyr[0][..., 0], cfg), None),
        ("epipolar trace (all candidates)", lambda: KS.trace_candidates(
            slam.imm, slam.window.frames, slam.calib.value, R, t, zero2, one, pyr[0], cfg), None),
        (f"ba_optimize ({cfg.max_opt_iterations} GN iters)",
         lambda w, c: ba_optimize(w, c, cfg, cfg.max_opt_iterations),
         lambda: state()[:2]),
        ("map cloud (viewer feed)", lambda: map_cloud(
            slam.window.frames, slam.window.points, slam.calib.value), None),
        ("kf_step (whole keyframe step)", kf, state),
    ]
    rows: List[Tuple[str, Optional[float], float]] = []
    for name, fn, prepare in phases:
        rows.append((name, *time_phase(fn, reps, dev, prepare)))

    trace_file = None
    if trace:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        os.makedirs(trace, exist_ok=True)
        with torch_profile(activities=acts) as prof:
            for _ in range(3):
                track()
                w, c = state()[:2]
                ba_optimize(w, c, cfg, cfg.max_opt_iterations)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        trace_file = os.path.join(trace, "profile_kf_trace.json")
        prof.export_chrome_trace(trace_file)

    after = state_leaves(slam)
    unchanged = after.keys() == before.keys() and all(
        torch.equal(after[k], v) if isinstance(v, torch.Tensor) else after[k] == v
        for k, v in before.items())
    return dict(rows=rows, state_unchanged=unchanged, trace_file=trace_file)


def print_rows(rows, reps: int, device: torch.device):
    where = (torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU")
    print(f"\nper-phase times on {where} (median of {reps}, ms):")
    print(f"  {'phase':42s} {'device span':>12s} {'host':>9s}")
    for name, dev_ms, host_ms in rows:
        d = "not measured" if dev_ms is None else f"{dev_ms:.3f}"
        print(f"  {name:42s} {d:>12s} {host_ms:9.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", type=str, default=None,
                    help="write a torch.profiler chrome trace into this directory")
    ap.add_argument("--frames", type=int, default=26)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    print("warming up (initialization and the first keyframes)...")
    t0 = time.perf_counter()
    slam, frames = warm_system(args.frames, args.device, BENCH_CFG)
    try:
        print(f"  {len(frames)} frames in {time.perf_counter() - t0:.1f} s, "
              f"{slam.next_kf_id} keyframes, initialized={slam.initialized}")
        out = profile(slam, frames[-1], args.reps, args.trace)
    finally:
        slam.close()
    print_rows(out["rows"], args.reps, slam.device)
    if out["trace_file"]:
        print(f"profiler trace written to {out['trace_file']}")
    if not out["state_unchanged"]:
        raise SystemExit("the system's state changed while it was profiled")


if __name__ == "__main__":
    main()
