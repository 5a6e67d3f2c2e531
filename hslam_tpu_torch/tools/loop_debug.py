"""Run the loop sequence through the pipelined entry with loop-closure gate
tracing (counterpart of scripts/bench_loop_debug.py): which gate of the
loop closer fires or blocks on bench.py's loop trajectory.

Usage:
    python -m hslam_tpu_torch.tools.loop_debug [--n-arc 162] [--device cpu]

`SLAMSystem(..., sequential=False)` with loop closure on the shipped
vocabulary and bench.py's capacities takes `n_arc` frames of io/synthetic's
arc, then io/synthetic.make_loop_frames (the arc again under exposure
flicker, the flight back, the revisit), all through
`process_frame_pipelined` with the mapping thread and the loop-closure
worker live, and HSLAM_LC_DEBUG=1 (every gate decision of `detect` on
stderr). It prints the keyframes, loops closed, revisits verified below
significance, relocalizations, `lc_detect_ms` p50/p95, the loop closer's
entries and `run_scale()`, and the gate decisions counted by gate. The
default `n_arc` is the JAX script's 162 (bench.py's WARMUP + MEASURE +
PACED + 2).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..io.synthetic import (LOOP_REP, LOOP_RET, LOOP_REV, Scene, make_loop_frames,
                            make_sequence)
from ..io.trajectory import ate_rmse
from ..models import loop_closure
from ..models.system import SLAMSystem
from .profile_kf import BENCH_CFG

N_ARC = 30 + 50 + 80 + 2            # bench.py:38-40 WARMUP + MEASURE + PACED + 2


def _feed(slam: SLAMSystem, frames, stamps, dev: torch.device) -> float:
    """Frames through the pipelined entry, drained; the wall seconds."""
    t0 = time.perf_counter()
    for img, ts in zip(frames, stamps):
        slam.process_frame_pipelined(img, ts)
    slam.flush_pipeline()
    slam.finish()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def run(n_arc: int = N_ARC, device="cuda", cfg: Optional[Config] = None,
        size=(480, 640, 320.0), loop=(LOOP_REP, LOOP_RET, LOOP_REV)) -> dict:
    """The arc, then the loop sequence, pipelined with loop closure. Returns
    the printed numbers; the system's thread exceptions are raised."""
    H, W, fx = size
    dev = torch.device(device)
    scene = Scene(H, W, fx)
    frames, centres = make_sequence(scene, n_arc)
    lf, lc, lstamps = make_loop_frames(scene, n_arc, *loop)
    was_debug = loop_closure._LC_DEBUG
    loop_closure._LC_DEBUG = True
    slam = SLAMSystem(fx, fx, W / 2 - 0.5, H / 2 - 0.5, W, H, cfg or BENCH_CFG,
                      sequential=False, device=dev)
    try:
        t_arc = _feed(slam, frames, [0.05 * i for i in range(n_arc)], dev)
        kfs_arc = slam.next_kf_id
        print(f"arc: {n_arc} frames in {t_arc:.1f} s ({n_arc / t_arc:.2f} fps), "
              f"keyframes {kfs_arc}")
        t_loop = _feed(slam, lf, lstamps, dev)
    finally:
        slam.close()
        loop_closure._LC_DEBUG = was_debug
    lcl = slam.loop_closer
    det = np.asarray(slam.lc_detect_ms, np.float64)
    allc = np.concatenate([centres, lc])
    valid = [s.id for s in slam.shells if s.pose_valid]
    est = np.array([slam.shells[i].cam_to_world[:3, 3] for i in valid])
    out = dict(
        frames=n_arc + len(lf), arc_seconds=t_arc, loop_seconds=t_loop,
        fps_arc=n_arc / t_arc, fps_loop=len(lf) / t_loop, keyframes_arc=kfs_arc,
        keyframes=slam.next_kf_id, valid=len(valid), lost=slam.is_lost,
        ate=float(ate_rmse(allc[valid], est)) if len(valid) > 2 else float("nan"),
        loops_closed=slam.n_loops_closed, verified_insignificant=lcl.n_verified_insignificant,
        relocs=slam.n_relocs, track_retries=slam.n_track_retries,
        lc_entries=len(lcl.entries), run_scale=float(lcl.run_scale()),
        lc_detect_p50=float(np.percentile(det, 50)) if det.size else float("nan"),
        lc_detect_p95=float(np.percentile(det, 95)) if det.size else float("nan"),
        n_detect=int(det.size), gates=dict(lcl.gate_counts))
    print(f"loop phase: {len(lf)} frames in {t_loop:.1f} s ({out['fps_loop']:.2f} fps) | "
          f"keyframes {out['keyframes']} loops {out['loops_closed']} verified below "
          f"significance {out['verified_insignificant']} relocs {out['relocs']}; valid poses "
          f"{out['valid']}/{out['frames']}, ATE {out['ate']:.6f}")
    print(f"lc_detect_ms p50 {out['lc_detect_p50']:.1f} p95 {out['lc_detect_p95']:.1f} "
          f"(n={out['n_detect']}); LC entries={out['lc_entries']} "
          f"run_scale={out['run_scale']:.4f}")
    print("gate decisions: " + ", ".join(f"{k} {v}" for k, v in sorted(out["gates"].items())))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-arc", type=int, default=N_ARC)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    run(args.n_arc, args.device)


if __name__ == "__main__":
    main()
