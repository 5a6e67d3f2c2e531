"""Run the port's SLAM system on a dataset from disk, or on a synthetic
sequence (counterpart of scripts/run_sequence.py).

Usage:
    python -m hslam_tpu_torch.tools.run_sequence --synthetic 60
    python -m hslam_tpu_torch.tools.run_sequence --dataset /path/to/seq [--out traj.txt]
    python -m hslam_tpu_torch.tools.run_sequence --synthetic 60 --trace trace.json

A dataset is any layout io/dataset.DatasetReader reads (TUM monoVO, EuRoC,
KITTI; directories or images.zip) with a camera.txt / camera.yaml. Frames
come through the prefetching loader (io/native_loader, as the JAX script's
native branch): two worker threads decode each frame eight ahead of the
system and correct it on the host, the inverse response and vignette
(pcalib.txt, vignette.png) and then the geometric remap, and the corrected
frame goes to `SLAMSystem.process_frame`. With --online-calib the frames
are only remapped: the system fits response, vignette and exposures itself.
--no-prefetch takes the JAX script's path without its native library:
decode on the calling thread, upload, the correction on the device
(`FrameCorrector`), the frame back to the host. Differences from the JAX
script:
  * --loop-closure switches loop closure in both branches (the JAX script's
    dataset branch leaves it on whatever the flag says);
  * --synthetic renders io/synthetic.py's textured plane (numpy draws): the
    JAX script's jax.random texture cannot be reproduced in torch;
  * --device picks the device (the card by default; "cpu" for tests).

--trace FILE turns the port's tracer (utils/trace.py) on for the run and
writes its spans at the end as a Chrome trace (chrome://tracing or
Perfetto): one track per thread (tracking, mapping, loop closure), each
span with its frame id and attributes, the counter totals under
"otherData".
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..io import native_loader
from ..io.dataset import DatasetReader
from ..io.synthetic import Scene, make_sequence
from ..io.trajectory import ate_rmse, write_tum
from ..models.system import SLAMSystem
from ..ops.undistort import invert_response, photometric_correct, remap_image
from ..utils import trace
from ..viz.debug_draw import save_debug_frame
from ..viz.view3d import MapServer


def synthetic_sequence(n_frames: int, loop: bool = False):
    """The JAX script's camera paths over io/synthetic's textured plane at
    depth 2, 320x240: a smooth arc, or a closed circuit back to the start.
    Returns (float32 frames, camera centres (N, 3), (fx, fy, cx, cy, w, h))."""
    h, w, fx, fy = 240, 320, 160.0, 160.0

    def xi(i):
        t = i / 30.0
        if loop:
            a = 2 * np.pi * i / max(n_frames - 1, 1)
            return np.array([0.35 * np.sin(a), 0.15 * (1 - np.cos(a)), 0.0,
                             0.01 * np.sin(a), 0.015 * np.sin(a), 0.0])
        return np.array([0.25 * np.sin(0.5 * t), 0.12 * (1 - np.cos(0.5 * t)), 0.06 * t,
                         0.02 * np.sin(0.4 * t), 0.03 * t, 0.01 * np.sin(0.3 * t)])

    frames, centres = make_sequence(Scene(h, w, fx, n_blobs=100), n_frames, xi,
                                    quantize=False)
    return frames, centres, (fx, fy, w / 2 - 0.5, h / 2 - 0.5, w, h)


class FrameCorrector:
    """Raw frame -> corrected frame on `device`: the inverse response and
    vignette of the dataset's photometric calibration (when `photometric`
    and the files exist), then the geometric remap. The reference's order
    (photometricUndistorter.cpp:121-146 before GeometricUndistorter):
    the vignette is the raw sensor's."""

    def __init__(self, rd: DatasetReader, photometric: bool, device):
        self.device = torch.device(device)
        self.remap = torch.as_tensor(rd.camera.remap, device=self.device)
        pc = rd.photometric
        self.inv_resp = None
        self.inv_vig = None
        if photometric:
            if pc.gamma is not None:
                self.inv_resp = invert_response(torch.as_tensor(pc.gamma, device=self.device))
            if pc.inv_vignette is not None:
                self.inv_vig = torch.as_tensor(pc.inv_vignette, device=self.device)

    def __call__(self, raw: torch.Tensor) -> torch.Tensor:
        return remap_image(photometric_correct(raw, self.inv_resp, self.inv_vig), self.remap)

    def to_host(self, raw: np.ndarray, times: Optional[FrameTimes] = None) -> np.ndarray:
        """The raw host frame corrected on the device and brought back, as
        process_frame takes it; with `times`, the correction's and the round
        trip's ms are recorded."""
        if times is None:
            return self(torch.from_numpy(raw).to(self.device)).cpu().numpy()
        t0 = time.perf_counter()
        dev_raw = torch.from_numpy(raw).to(self.device)
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self(dev_raw)
            ev[1].record()
            ev[1].synchronize()
            times.correct.append(ev[0].elapsed_time(ev[1]))
        else:
            out = self(dev_raw)
            times.correct.append(1e3 * (time.perf_counter() - t1))
        t2 = time.perf_counter()
        img = out.cpu().numpy()
        times.round_trip.append(1e3 * ((t1 - t0) + (time.perf_counter() - t2)))
        return img


@dataclasses.dataclass
class FrameTimes:
    """Per processed frame, in ms. Through the loader: wait (the consumer
    blocked in `get`, host clock). Inline (--no-prefetch): decode (cv2,
    host clock), correct (the photometric correction and the remap: CUDA
    events on the card, the host clock on the CPU) and round_trip (the raw
    frame up, the corrected frame back, host clock). Both: process
    (process_frame, host clock to a synchronised device)."""
    wait: List[float] = dataclasses.field(default_factory=list)
    decode: List[float] = dataclasses.field(default_factory=list)
    correct: List[float] = dataclasses.field(default_factory=list)
    round_trip: List[float] = dataclasses.field(default_factory=list)
    process: List[float] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        names = (("loader wait", self.wait), ("decode", self.decode),
                 ("correct+remap", self.correct), ("round trip", self.round_trip),
                 ("process_frame", self.process))
        return ", ".join(f"{name} p50 {np.percentile(xs, 50):.2f} p95 {np.percentile(xs, 95):.2f}"
                         for name, xs in names if xs) + " ms"


@dataclasses.dataclass
class RunResult:
    system: SLAMSystem
    n_frames: int                 # frames handed to the system
    seconds: float
    n_skipped: int = 0            # --realtime: frames dropped behind schedule
    times: Optional[FrameTimes] = None
    viewer: Optional[MapServer] = None


def open_loader(rd: DatasetReader, photometric: bool, n_prefetch: int = 8, n_threads: int = 2):
    """The prefetching loader over `rd`'s frames, correcting them as
    FrameCorrector does (the inverse response and vignette when
    `photometric`, then the remap): NativeLoader over the files of a
    directory, NativeMemLoader over the members of images.zip (read on the
    caller's thread). scripts/run_sequence.py:188-209."""
    pc = rd.photometric
    inv_resp = inv_vig = None
    if photometric:
        if pc.gamma is not None:
            inv_resp = invert_response(torch.as_tensor(pc.gamma)).numpy()
        inv_vig = pc.inv_vignette
    kw = dict(n_prefetch=n_prefetch, n_threads=n_threads, inv_response=inv_resp,
              inv_vignette=inv_vig, remap=rd.camera.remap)
    if rd._zip is None:
        return native_loader.NativeLoader(rd.files, **kw)
    zf, files = rd._zip, list(rd.files)
    return native_loader.NativeMemLoader(len(files), lambda i: zf.read(files[i]), **kw)


def run_dataset(args, metrics: Optional[str], cfg: Config) -> RunResult:
    """The dataset branch: every frame corrected on the host by the
    prefetching loader (or, with --no-prefetch, decoded here, corrected on
    the device and pulled back) and handed to the sequential system."""
    rd = DatasetReader(args.dataset)
    loader = None
    try:
        cam = rd.camera
        if cam is None:
            raise SystemExit(f"{args.dataset}: no geometric calibration found "
                             "(camera.txt / calib.txt / camera.yaml)")
        K = cam.out_K
        slam = SLAMSystem(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cam.out_size[0],
                          cam.out_size[1], cfg,
                          enable_loop_closure=args.loop_closure,
                          online_photo_calib=args.online_calib, vocab_path=args.vocab,
                          metrics_path=metrics, device=args.device)
        # online calibration fits response and vignette itself: raw frames,
        # remapped only (the reversed order of DatasetLoader.h:436-506)
        photometric = not args.online_calib
        if args.no_prefetch:
            correct = FrameCorrector(rd, photometric, args.device)
        else:
            loader = open_loader(rd, photometric)
        device = torch.device(args.device)
        times = FrameTimes()
        n = len(rd) if not args.max_frames else min(len(rd), args.max_frames)
        n_done = n_skipped = 0
        try:
            t0 = time.perf_counter()
            i = 0
            while i < n:
                ta = time.perf_counter()
                if loader is not None:
                    img = loader.get(i)
                    ts, exp = rd.timestamps[i], rd.exposures[i]
                    tc = time.perf_counter()
                    times.wait.append(1e3 * (tc - ta))
                else:
                    fd = rd.get_raw(i)
                    times.decode.append(1e3 * (time.perf_counter() - ta))
                    img = correct.to_host(fd.image, times)
                    ts, exp = fd.timestamp, fd.exposure
                    tc = time.perf_counter()
                slam.process_frame(img, ts, exp)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                times.process.append(1e3 * (time.perf_counter() - tc))
                n_done += 1
                if args.viz_dir and slam.shells[-1].is_kf:
                    os.makedirs(args.viz_dir, exist_ok=True)
                    save_debug_frame(os.path.join(args.viz_dir, f"kf_{slam.next_kf_id:04d}.png"),
                                     slam, img)
                if slam.is_lost:
                    print(f"LOST at frame {i}")
                    break
                i += 1
                if args.realtime and i < n:
                    # skip frames whose timestamp has already passed, wait when
                    # ahead (Main.cpp:91-106)
                    wall = time.perf_counter() - t0
                    while i < n - 1 and rd.timestamps[i] - rd.timestamps[0] < wall:
                        i += 1
                        n_skipped += 1
                    ahead = (rd.timestamps[i] - rd.timestamps[0]) - wall
                    if ahead > 0:
                        time.sleep(min(ahead, 1.0))
        except BaseException:
            slam.close()
            raise
        return RunResult(slam, n_done, time.perf_counter() - t0, n_skipped, times)
    finally:
        if loader is not None:
            loader.close()
        rd.close()


def run_synthetic(args, metrics: Optional[str], cfg: Config) -> RunResult:
    frames, centres, (fx, fy, cx, cy, w, h) = synthetic_sequence(
        args.synthetic, loop=args.loop_trajectory)
    slam = SLAMSystem(fx, fy, cx, cy, w, h, cfg, enable_loop_closure=args.loop_closure,
                      online_photo_calib=args.online_calib, vocab_path=args.vocab,
                      metrics_path=metrics, device=args.device)
    t0 = time.perf_counter()
    try:
        for i, img in enumerate(frames):
            slam.process_frame(img, i / 30.0)
            if slam.is_lost:
                print(f"LOST at frame {i}")
                break
    except BaseException:
        slam.close()
        raise
    res = RunResult(slam, len(slam.shells), time.perf_counter() - t0)
    valid = [s.id for s in slam.shells if s.pose_valid]
    if len(valid) > 5 and slam.initialized:
        est = np.array([slam.shells[k].cam_to_world[:3, 3] for k in valid])
        print(f"ATE RMSE (sim3-aligned): {ate_rmse(centres[valid], est):.4f} "
              "(scene depth = 2.0)")
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--dataset", type=str, default=None)
    ap.add_argument("--out", type=str, default="traj.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--realtime", action="store_true",
                    help="pace playback by input timestamps, skipping frames "
                         "when behind (reference Main.cpp:91-106 semantics)")
    ap.add_argument("--viz-dir", type=str, default=None,
                    help="write per-keyframe debug PNGs here")
    ap.add_argument("--loop-closure", action="store_true",
                    help="enable BoW loop closure + pose-graph correction")
    ap.add_argument("--loop-trajectory", action="store_true",
                    help="synthetic: fly a closed loop that revisits the start")
    ap.add_argument("--vocab", type=str, default=None,
                    help="BoW vocabulary .npz (default: the shipped 10^4 words; "
                         "'online' trains one from the first keyframes)")
    ap.add_argument("--metrics", type=str, default=None,
                    help="write per-frame/per-keyframe JSONL metrics here")
    ap.add_argument("--view3d", action="store_true",
                    help="serve the live 3D map (WebGL point clouds + "
                         "frusta + trajectory) at http://localhost:PORT")
    ap.add_argument("--view3d-port", type=int, default=8642,
                    help="0 picks a free port")
    ap.add_argument("--online-calib", action="store_true",
                    help="estimate response/vignette/exposure online "
                         "(OnlineCalibrator capability; frames are fed RAW)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="decode on the calling thread and correct on the device "
                         "(the JAX script's path without its native loader)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--trace", type=str, default=None, metavar="FILE",
                    help="record the system's spans and counters and write them "
                         "here as a Chrome trace (JSON)")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.dataset:
        ap.error("need --synthetic N or --dataset DIR")
    return args


# the synthetic branch's capacities (the JAX script's); a dataset runs Config()
SYNTHETIC_CFG = Config(max_frames=8, max_points=2048, max_immature=2048, max_features=2048,
                       pyr_levels=4)


def run(args, cfg: Optional[Config] = None) -> RunResult:
    """One run as the command line asks for it: the sequence, then the
    trajectory written to args.out. With --view3d the returned result holds
    the live viewer, still serving; the caller stops it. `cfg` replaces the
    branch's configuration (tests run small ones)."""
    if not args.synthetic:
        print("frames decoded on the calling thread, corrected on the device"
              if args.no_prefetch else
              "frames through the prefetching loader (2 threads, 8 ahead, corrected on the host)")
    metrics = args.metrics
    viewer = None
    if args.view3d:
        if metrics is None:
            metrics = os.path.splitext(args.out)[0] + ".metrics.jsonl"
        open(metrics, "w").close()          # fresh stream for the viewer
        viewer = MapServer(metrics, port=args.view3d_port).start()
        print(f"live 3D map at {viewer.url}  (drag orbit / wheel zoom / F follow)")
    if args.trace:
        trace.enable()
    try:
        if args.synthetic:
            res = run_synthetic(args, metrics, cfg or SYNTHETIC_CFG)
        else:
            res = run_dataset(args, metrics, cfg or Config())
        slam = res.system
        slam.close()
        if args.trace:
            trace.disable()
            with open(args.trace, "w") as f:
                json.dump(trace.chrome_trace(trace.snapshot()), f)
            print(f"spans written to {args.trace}")
        n_proc = len(slam.shells)
        skipped = f", skipped {res.n_skipped}" if args.realtime else ""
        print(f"{n_proc} frames in {res.seconds:.1f}s ({n_proc / res.seconds:.1f} fps), "
              f"{slam.next_kf_id} KFs, initialized={slam.initialized}, "
              f"loops_closed={slam.n_loops_closed}{skipped}")
        if res.times is not None and res.times.process:
            print(f"per frame: {res.times.summary()}")
        write_tum(args.out, [s.timestamp for s in slam.shells],
                  [(s.cam_to_world[:3, :3], s.cam_to_world[:3, 3]) for s in slam.shells])
        print(f"trajectory written to {args.out}")
    except BaseException:
        if viewer is not None:
            viewer.stop()
        raise
    finally:
        if args.trace:
            trace.disable()
    res.viewer = viewer
    return res


def main(argv=None):
    res = run(parse_args(argv))
    if res.viewer is not None:
        print(f"sequence done — viewer still serving at {res.viewer.url}; Ctrl-C to exit")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            res.viewer.stop()


if __name__ == "__main__":
    main()
