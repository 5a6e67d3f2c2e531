"""Run the BASELINE.json evaluation configs on the port from a dataset root
(counterpart of scripts/eval_baseline.py).

    python -m hslam_tpu_torch.tools.eval_baseline --dataset /data/euroc/MH_01 --config 1
    python -m hslam_tpu_torch.tools.eval_baseline --dataset-root /data/euroc \
        --sequences MH_01,MH_02,V1_01 --config 1 3 --json table.json

Configs (BASELINE.json `configs`):
  1  Monocular odometry (CoarseTracker + windowed photometric BA, LC off)
  2  TUM-MonoVO with photometric calibration (pcalib.txt + vignette.png,
     the photometricUndistorter path, photometricUndistorter.cpp:121-146)
  3  Full hybrid: indirect features + BoW loop closure + pose graph
  4  Online photometric calibration (OnlineCalibrator capability — frames
     fed RAW, response/vignette/exposure estimated on the device)
  5  Distributed (sharded BA + pose graph): this tool prints guidance only.

Each config runs the pipelined entry (the mapping thread), so which frames
become keyframes depends on thread timing. Unlike the JAX script, config 2
corrects a frame photometrically before the geometric remap, as the
reference and run_sequence do: the vignette is the raw sensor's (ROADMAP
C17). Ground truth: EuRoC `mav0/state_groundtruth_estimate0/data.csv` and a
TUM-format `groundtruth.txt` are found automatically, others via --gt. ATE
is Sim3-aligned RMSE with nearest-timestamp association (<= 20 ms).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..config import Config
from ..io.dataset import DatasetReader
from ..io.trajectory import ate_rmse
from ..models.system import SLAMSystem
from .run_sequence import FrameCorrector

CONFIG_NAMES = {
    1: "mono odometry (LC off)",
    2: "photometric calib (pcalib+vignette)",
    3: "full hybrid (features + LC + pose graph)",
    4: "online photometric calibration",
}


def load_groundtruth(dataset_path: str, gt_path: str | None):
    """Returns (timestamps (N,), positions (N, 3)) or None."""
    cands = []
    if gt_path:
        cands.append(gt_path)
    cands.append(os.path.join(dataset_path, "mav0",
                              "state_groundtruth_estimate0", "data.csv"))
    cands.append(os.path.join(dataset_path, "groundtruth.txt"))
    for c in cands:
        if not os.path.exists(c):
            continue
        ts, pos = [], []
        with open(c) as f:
            for ln in f:
                if ln.startswith("#"):
                    continue
                # EuRoC csv: t[ns],x,y,z,...; TUM: t x y z qx qy qz qw
                fl = ln.strip().split(",") if c.endswith(".csv") else ln.strip().split()
                if len(fl) < 4:
                    continue
                ts.append(float(fl[0]) * (1e-9 if c.endswith(".csv") else 1.0))
                pos.append([float(fl[1]), float(fl[2]), float(fl[3])])
        if ts:
            return np.asarray(ts), np.asarray(pos)
    return None


def associate_ate(shells, gt, max_dt=0.02):
    """Sim3-aligned ATE of pose-valid shells against (ts, pos) GT."""
    gts, gpos = gt
    est, ref = [], []
    for s in shells:
        if not s.pose_valid:
            continue
        j = int(np.searchsorted(gts, s.timestamp))
        best, bdt = None, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(gts) and abs(gts[k] - s.timestamp) <= bdt:
                best, bdt = k, abs(gts[k] - s.timestamp)
        if best is None:
            continue
        est.append(s.cam_to_world[:3, 3])
        ref.append(gpos[best])
    if len(est) < 8:
        return float("nan"), len(est)
    return ate_rmse(np.stack(ref), np.stack(est)), len(est)


def run_config(dataset_path: str, config_id: int, calib: str | None = None,
               gt_path: str | None = None, max_frames: int = 0,
               cfg_override=None, vocab: str | None = None, device="cuda"):
    """Run one BASELINE config on one sequence; returns a result dict (the
    JAX script's keys, `n_valid_poses` and `n_track_retries`)."""
    rd = DatasetReader(dataset_path, calib_path=calib)
    try:
        if rd.camera is None:
            raise SystemExit(
                f"{dataset_path}: no geometric calibration found (camera.txt / "
                f"camera.yaml / --calib); reference requires one "
                f"(GeometricUndistorter.cpp:26-78)")
        cam = rd.camera
        K = cam.out_K
        w, h = cam.out_size
        cfg = cfg_override or Config(max_frames=8, max_points=2048,
                                     max_immature=2048, max_features=2048,
                                     pyr_levels=4)
        online = config_id == 4
        slam = SLAMSystem(
            K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h, cfg,
            enable_loop_closure=(config_id == 3),
            online_photo_calib=online, vocab_path=vocab, sequential=False,
            device=device)
        try:
            correct = FrameCorrector(rd, config_id == 2, device)
            n = len(rd) if max_frames <= 0 else min(len(rd), max_frames)
            t0 = time.perf_counter()
            for i in range(n):
                fr = rd.get_raw(i)
                slam.process_frame_pipelined(correct.to_host(fr.image), fr.timestamp,
                                             exposure=fr.exposure)
            slam.flush_pipeline()
            slam.finish()
            wall = time.perf_counter() - t0
        finally:
            slam.close()
    finally:
        rd.close()
    gt = load_groundtruth(dataset_path, gt_path)
    ate, n_assoc = (float("nan"), 0) if gt is None else associate_ate(
        slam.shells, gt)
    return {
        "config": config_id,
        "config_name": CONFIG_NAMES[config_id],
        "sequence": os.path.basename(dataset_path.rstrip("/")),
        "n_frames": n,
        "fps": round(n / wall, 2),
        "initialized": bool(slam.initialized),
        "n_keyframes": int(slam.next_kf_id),
        "n_loops_closed": int(slam.n_loops_closed),
        "n_relocs": int(slam.n_relocs),
        "ate_rmse": None if np.isnan(ate) else round(float(ate), 4),
        "gt_matched_frames": n_assoc,
        "n_valid_poses": sum(s.pose_valid for s in slam.shells),
        "n_track_retries": int(slam.n_track_retries),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", help="one sequence directory")
    ap.add_argument("--dataset-root", help="root holding sequence dirs")
    ap.add_argument("--sequences", default="",
                    help="comma-separated sequence names under root")
    ap.add_argument("--config", type=int, nargs="+", default=[1],
                    help="BASELINE config ids (1-5)")
    ap.add_argument("--calib", default=None,
                    help="geometric calib file (camera.txt / OpenCV yaml, "
                         "e.g. the reference Extras/Calib/*.yaml)")
    ap.add_argument("--gt", default=None, help="ground-truth file")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--json", default=None, help="write results as JSON")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dataset:
        seqs = [args.dataset]
    elif args.dataset_root:
        names = ([s for s in args.sequences.split(",") if s]
                 or sorted(os.listdir(args.dataset_root)))
        seqs = [os.path.join(args.dataset_root, s) for s in names]
    else:
        ap.error("need --dataset or --dataset-root")

    rows = []
    for cid in args.config:
        if cid == 5:
            print("config 5 (distributed) is not a single-sequence run: check the "
                  "sharded solvers with `python -m hslam_tpu_torch.parallel.dryrun N` "
                  "and tests/test_torch_dist.py, and run SLAMSystem(dist_mesh=...) "
                  "on every rank (hslam_tpu_torch/parallel/__init__.py)")
            continue
        for seq in seqs:
            print(f"== config {cid} ({CONFIG_NAMES[cid]}) on {seq}")
            r = run_config(seq, cid, calib=args.calib, gt_path=args.gt,
                           max_frames=args.max_frames, vocab=args.vocab,
                           device=args.device)
            rows.append(r)
            print("   " + json.dumps(r))

    if rows:
        print("\n| config | sequence | frames | fps | KFs | loops | ATE |")
        print("|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['config']} | {r['sequence']} | {r['n_frames']} | "
                  f"{r['fps']} | {r['n_keyframes']} | "
                  f"{r['n_loops_closed']} | {r['ate_rmse']} |")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"results -> {args.json}")


if __name__ == "__main__":
    main()
