"""Tracking: the window's calls of the program's coarse-to-fine tracker held
against the reference's rectification, pyramid and alignment.

Capture. For the window, `ops.tracker.track_coarse` is wrapped: both
entries reach it (the pipelined one through track_step and
track_coarse_multi, the sequential one through track_coarse_multi and its
serial fallback). The wrapper keeps references, never copies, to the
arguments and results of a sample of calls drawn from the seed: the
template the frame was tracked against (every level), the frame's pyramid
(the CUDA kernel's output), the start pose and affine brightness the
program chose, the exposures, the abort thresholds, how many calibration
refits had landed, and the pose refToNew and affine brightness it returned.
It keeps the harness's last handed-over frames (the program's rectified
frames) with each call.

Judgement, per captured call, after the window:
- rectify_gap: the program's rectified frame against the reference's
  rectification of the same raw frame (grey levels, the largest pixel);
- pyramid_gap: the program's pyramid [I, dx, dy] against the reference
  pyramid of the reference's rectified frame, through the reference's own
  calibrated correction in force at the frame where the photo_calib judge
  runs (grey levels);
- track_px_gap: the reference runs the stated coarse-to-fine alignment
  (reference/tracker.py) in float64 from the program's start, on the
  reference pyramid; the largest shift, in level-0 pixels, of a template
  point between the program's answer and the reference's;
- track_aff_gap: the largest difference of the two brightness maps over
  intensities 0..255 (grey levels).
Each reading is the largest over the captured calls; `judged_calls` counts
the accepted answers judged. The control puts the reference, computed in
bfloat16, in the program's place: its rectified frame, its pyramid (through
the bfloat16 refits of the photo_calib judge), and its alignment from the
same start.
"""
from __future__ import annotations

import dataclasses
import inspect
import threading
from typing import List, Optional

import numpy as np
import torch

from slambench.judge import Judged, gap, lens_K
from slambench.reference import image as RI
from slambench.reference import tracker as RT

NUMBERS = ("rectify_gap", "pyramid_gap", "track_px_gap", "track_aff_gap")
MINIMUMS = {"judged_calls": 3}      # fewer judged calls: the answers never came
AFTER = ("photo_calib",)
SCOPE = "window"
CAPTURE_EVERY = 8        # about one call in CAPTURE_EVERY is captured
MAX_CAPTURES = 24


@dataclasses.dataclass
class Capture:
    frame: Optional[int]        # the harness's frame index (sequential entry)
    candidates: list            # [(frame index, program's rectified host frame)]
    pyr: list                   # the program's pyramid, (H_l, W_l, 3) per level
    tpl: list                   # template per level: (u, v, idepth, color, valid)
    start: tuple                # (R0, t0, aff0) the program started from
    exp_ref: torch.Tensor
    exp_new: torch.Tensor
    aff_ref: torch.Tensor
    coarsest: int
    min_res: Optional[torch.Tensor]
    R: torch.Tensor             # the program's answer
    t: torch.Tensor
    aff: torch.Tensor
    ok: torch.Tensor
    n_fits: int                 # calibration refits landed before the call


class Capturer:
    """Wraps ops.tracker.track_coarse; a sequential entry tracks the newest
    handed-over frame only."""

    def __init__(self, ctx):
        self.offset = ctx.seed % CAPTURE_EVERY
        self.calls = 0
        self.ctx = ctx
        self.captured: List[Capture] = []
        self._lock = threading.Lock()
        self._module = self._saved = None

    def _take(self) -> bool:
        with self._lock:
            k = self.calls
            self.calls += 1
            return k % CAPTURE_EVERY == self.offset and len(self.captured) < MAX_CAPTURES

    def _wrap(self, fn):
        sig = inspect.signature(fn)

        def captured(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self._take():
                self.captured.append(self._record(sig.bind(*args, **kwargs), out))
            return out
        return captured

    def _record(self, bound, res) -> Capture:
        a = bound.arguments
        tpl = a["template"]
        levels = [(tpl.u[lv], tpl.v[lv], tpl.idepth[lv], tpl.color[lv], tpl.valid[lv])
                  for lv in range(len(tpl.u))]
        pyr = list(a["target_pyr"])
        coarsest = a.get("coarsest_lvl")
        recent = list(self.ctx.recent)
        return Capture(
            recent[-1][0] if self.ctx.sequential else None, recent, pyr, levels,
            (a["R0"], a["t0"], a["aff0"]), a["exp_ref"], a["exp_new"], a["aff_ref"],
            len(pyr) - 1 if coarsest is None else int(coarsest), a.get("min_res_for_abort"),
            res.R, res.t, res.aff, res.ok, self.ctx.system.n_photo_fits)

    def install(self):
        from hslam_tpu_torch.ops import tracker
        self._module, self._saved = tracker, tracker.track_coarse
        tracker.track_coarse = self._wrap(self._saved)

    def remove(self):
        if self._saved is not None:
            self._module.track_coarse = self._saved
            self._saved = None


def _frame_of(cap: Capture):
    """(frame index, program's rectified frame) of a capture. A pipelined
    call may track an older staged frame (a retry): its pyramid's level 0 is
    matched against the frames the harness handed over last."""
    if cap.frame is not None:
        return cap.candidates[-1]
    img = cap.pyr[0][..., 0].detach().cpu().numpy()
    for idx, rect in reversed(cap.candidates):
        if rect.shape == img.shape and np.array_equal(rect, img):
            return idx, rect
    return None


def judge(captured: List[Capture], inputs, state, control) -> Judged:
    cam, cfg, device = inputs.lens, inputs.cfg, inputs.device
    tracker = dict(cfg["tracker"], iters_per_level=cfg["tracker"]["tracker_iters_per_level"])
    levels = int(cfg["capacities"]["pyr_levels"])
    calib = state.get("photo_calib")
    chain = calib["corrections"] if calib else []
    c_chain = (calib["control"] if calib else []) if control else None
    prog = {k: 0.0 for k in NUMBERS}
    ctrl = {k: 0.0 for k in NUMBERS}
    n = dict(captured=len(captured), unmatched=0, rejected=0, judged_calls=0)
    rows = []
    f64 = torch.float64
    for cap in captured:
        got = _frame_of(cap)
        if got is None:
            n["unmatched"] += 1
            continue
        idx, rect = got
        raw = inputs.raw_of(idx).to(device)
        ref = RI.rectify(raw, cam, f64)
        prog["rectify_gap"] = max(prog["rectify_gap"],
                                  gap(torch.as_tensor(rect, device=device), ref))
        if cap.n_fits > len(chain):
            n["unmatched"] += 1     # a correction the judged refits do not explain
            continue
        ref_pyr = RI.pyramid(_calibrated(ref, _after(chain, cap.n_fits)), levels)
        prog["pyramid_gap"] = max(prog["pyramid_gap"], _pyr_gap(cap.pyr, ref_pyr))
        if control:
            c_rect = RI.rectify(raw, cam, torch.bfloat16)
            ctrl["rectify_gap"] = max(ctrl["rectify_gap"], gap(c_rect, ref))
            c_pyr = RI.pyramid(_calibrated(c_rect, _after(c_chain, cap.n_fits)), levels)
            ctrl["pyramid_gap"] = max(ctrl["pyramid_gap"], _pyr_gap(c_pyr, ref_pyr))
        if not bool(cap.ok):
            n["rejected"] += 1      # the program discarded this answer itself
            continue
        n["judged_calls"] += 1
        K0 = lens_K(cam)
        args = (K0, cap.exp_ref, cap.exp_new, cap.aff_ref, *cap.start, tracker, cap.coarsest,
                None if cap.min_res is None else cap.min_res.tolist())
        R, t, aff, _ = RT.track_coarse(cap.tpl, ref_pyr, *args, dtype=f64)
        px = RT.pose_gap_px(cap.tpl[0], K0, cap.R, cap.t, R, t)
        af = RT.affine_gap(cap.exp_ref, cap.exp_new, cap.aff_ref, cap.aff, aff)
        prog["track_px_gap"] = max(prog["track_px_gap"], px)
        prog["track_aff_gap"] = max(prog["track_aff_gap"], af)
        rows.append(dict(frame=idx, px=px, aff=af))
        if control:
            cR, ct, caff, _ = RT.track_coarse(cap.tpl, c_pyr, *args, dtype=torch.bfloat16)
            ctrl["track_px_gap"] = max(ctrl["track_px_gap"],
                                       RT.pose_gap_px(cap.tpl[0], K0, cR, ct, R, t))
            ctrl["track_aff_gap"] = max(ctrl["track_aff_gap"], RT.affine_gap(
                cap.exp_ref, cap.exp_new, cap.aff_ref, caff, aff))
    return Judged(prog, n, rows, ctrl if control else None)


def _calibrated(img, luts):
    if luts is None:
        return img
    inv_resp, inv_vig = luts[:2]
    return RI.photometric_correct(img, inv_resp, inv_vig)


def _after(corrections: list, n_fits: int):
    """The reference's correction in force once `n_fits` refits have landed
    (None before the first)."""
    return corrections[n_fits - 1] if n_fits else None


def _pyr_gap(pa, pb) -> float:
    if len(pa) != len(pb):
        return float("inf")
    return max(gap(a, b) if a.shape == b.shape else float("inf") for a, b in zip(pa, pb))
