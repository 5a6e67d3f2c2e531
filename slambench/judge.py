"""What decides `correct`: the timed path's own answers, captured in the
window, held against the plain reference (reference/) once it has closed.

Capture. Every run (traced or not) wraps the program's coarse-to-fine
tracker, `ops.tracker.track_coarse`, for the window: both entries reach it
(the pipelined one through track_step and track_coarse_multi, the
sequential one through track_coarse_multi and its serial fallback). The
wrapper keeps references, never copies, to the arguments and results of a
sample of calls drawn from the seed: the template the frame was tracked
against (every level), the frame's pyramid (the CUDA kernel's output), the
start pose and affine brightness the program chose, the exposures, the
abort thresholds, how many calibration refits had landed, and the pose
refToNew and affine brightness it returned. The harness keeps the program's
rectified frames of those calls.

Judgement, per captured call, after the window:
- rectify_gap: the program's rectified frame against the reference's
  rectification of the same raw frame (grey levels, the largest pixel);
- pyramid_gap: the program's pyramid [I, dx, dy] against the reference
  pyramid of the reference's rectified frame (through the reference's own
  calibrated correction where one is in force; grey levels);
- track_px_gap: the reference runs the stated coarse-to-fine alignment
  (reference/tracker.py) in float64 from the program's start, on the
  reference pyramid; the largest shift, in level-0 pixels, of a template
  point between the program's answer and the reference's;
- track_aff_gap: the largest difference of the two brightness maps over
  intensities 0..255 (grey levels).
- calib_gap (configurations with the online calibration): every refit of
  the run, from the first, is captured: the frames of the ring, their
  poses relative to the template's keyframe and the template's level-0
  points the program sampled them at, the program's previous fit, and the
  correction the program put in force after the refit. The reference
  redoes each refit (reference/photo_calib.py) from its own rectification
  of the raw frames and the handed-over exposures, starting from the
  program's previous fit as the program does (the first from the stated
  initial values), and blends it into its own previous correction; the
  reading is the largest difference, over the refits, intensities 0..255
  and a grid of pixels, of the corrected intensity Binv(I) / V(x) (grey
  levels). The pyramid's reference above applies the reference's own
  correction in force at the frame.
Each reading is the largest over the captured calls. The control puts the
reference, computed in bfloat16, in the program's place: its rectified
frame, its refits, its pyramid, and its alignment from the same start.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from slambench.reference import image as RI
from slambench.reference import photo_calib as RP
from slambench.reference import tracker as RT

NUMBERS = ("rectify_gap", "pyramid_gap", "track_px_gap", "track_aff_gap", "calib_gap")
CALIB_GRID = 4           # calib_gap reads every CALIB_GRID-th pixel in each direction
CAPTURE_EVERY = 8        # about one call in CAPTURE_EVERY is captured
MAX_CAPTURES = 24
MIN_JUDGED = 3           # fewer judged calls: the answers never came
MIN_FITS = 3             # fewer refits in a calibrating run: the fits never came


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


@dataclasses.dataclass
class Fit:
    frames: List[int]           # the ring's frame indices, oldest first
    R: np.ndarray               # (F, 3, 3), (F, 3): each ring frame from the keyframe
    t: np.ndarray
    tpl: tuple                  # the template's level 0: (u, v, idepth, valid)
    before: Optional[tuple]     # the program's previous fit (None before the first)
    luts: tuple                 # the correction in force after it: (Binv, 1/V, B')
    n: int                      # the program's count of refits after it


class Capturer:
    """Wraps ops.tracker.track_coarse for the window and, with the online
    calibration, the system's refit for the whole run (see the module's
    docstring). The harness keeps `recent`, the last frames it handed over
    as [(index, rectified host frame)], newest last; a sequential entry
    tracks the newest one only."""

    def __init__(self, seed: int, system, sequential: bool, rate_hz: float):
        self.offset = seed % CAPTURE_EVERY
        self.calls = 0
        self.system = system
        self.rate = rate_hz
        self.recent: list = []
        self.sequential = sequential
        self.captures: List[Capture] = []
        self.fits: List[Fit] = []
        self._saved = None

    def _take(self) -> bool:
        k = self.calls
        self.calls += 1
        return k % CAPTURE_EVERY == self.offset and len(self.captures) < MAX_CAPTURES

    def _wrap(self, fn):
        sig = inspect.signature(fn)

        def captured(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self._take():
                self.captures.append(self._record(sig.bind(*args, **kwargs), out))
            return out
        return captured

    def _record(self, bound, res) -> Capture:
        a = bound.arguments
        tpl = a["template"]
        levels = [(tpl.u[lv], tpl.v[lv], tpl.idepth[lv], tpl.color[lv], tpl.valid[lv])
                  for lv in range(len(tpl.u))]
        pyr = list(a["target_pyr"])
        coarsest = a.get("coarsest_lvl")
        return Capture(
            self.recent[-1][0] if self.sequential else None, list(self.recent), pyr, levels,
            (a["R0"], a["t0"], a["aff0"]), a["exp_ref"], a["exp_new"], a["aff_ref"],
            len(pyr) - 1 if coarsest is None else int(coarsest), a.get("min_res_for_abort"),
            res.R, res.t, res.aff, res.ok, self.system.n_photo_fits)

    def install_fits(self):
        """Capture every calibration refit of the system from now on: what
        the refit reads (the ring, the poses, the template) just before it
        runs, and the correction in force once it has landed."""
        slam = self.system
        step = slam._photo_calib_step

        def captured():
            if slam.template is None:
                return step()
            with slam._shell_lock:
                ids = [sid for sid, _ in slam._pc_ring]
                ref = slam.shells[slam.ref_shell_id].cam_to_world
                rel = np.stack([np.linalg.inv(slam.shells[sid].cam_to_world) @ ref for sid in ids])
                frames = [int(round(slam.shells[sid].timestamp * self.rate)) for sid in ids]
            tpl = slam.template
            lv0 = (tpl.u[0], tpl.v[0], tpl.idepth[0], tpl.valid[0])
            before = slam._pc_params
            landed = step()
            if landed:
                self.fits.append(Fit(frames, rel[:, :3, :3], rel[:, :3, 3], lv0, before,
                                     slam._pc_luts, slam.n_photo_fits))
            return landed
        slam._photo_calib_step = captured

    def remove_fits(self):
        self.system.__dict__.pop("_photo_calib_step", None)

    def install(self, tracker_module):
        self._saved = tracker_module.track_coarse
        tracker_module.track_coarse = self._wrap(self._saved)

    def remove(self, tracker_module):
        if self._saved is not None:
            tracker_module.track_coarse = self._saved
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


def judge(captures: List[Capture], fits: List[Fit], raw_of, exp_of, cam, cfg: dict, device,
          control: bool = False) -> Dict[str, dict]:
    """Readings of NUMBERS over the captures: {"program": {...}, "n": {...}}
    and, with `control`, {"control": {...}}. `raw_of(frame index)` gives
    the raw uint8 host frame, `exp_of(frame index)` the exposure handed
    over with it."""
    tracker = dict(cfg["tracker"], iters_per_level=cfg["tracker"]["tracker_iters_per_level"])
    levels = int(cfg["capacities"]["pyr_levels"])
    prog = {k: 0.0 for k in NUMBERS}
    ctrl = {k: 0.0 for k in NUMBERS}
    n = dict(captured=len(captures), unmatched=0, rejected=0, judged=0, fits=len(fits))
    calls = []
    f64 = torch.float64
    chain = _refits(fits, raw_of, exp_of, cam, cfg, device, f64)
    c_chain = _refits(fits, raw_of, exp_of, cam, cfg, device, torch.bfloat16) if control else None
    for k, fit in enumerate(fits):
        prog["calib_gap"] = max(prog["calib_gap"], math.inf if fit.n != k + 1 else
                                _correction_gap(fit.luts, chain[k]))
        if control:
            ctrl["calib_gap"] = max(ctrl["calib_gap"], _correction_gap(c_chain[k], chain[k]))
    for cap in captures:
        got = _frame_of(cap)
        if got is None:
            n["unmatched"] += 1
            continue
        idx, rect = got
        raw = raw_of(idx).to(device)
        ref = RI.rectify(raw, cam, f64)
        prog["rectify_gap"] = max(prog["rectify_gap"],
                                  _gap(torch.as_tensor(rect, device=device), ref))
        if cap.n_fits > len(fits):
            n["unmatched"] += 1     # a correction the captured refits do not explain
            continue
        ref_pyr = RI.pyramid(_calibrated(ref, _after(chain, cap.n_fits)), levels)
        prog["pyramid_gap"] = max(prog["pyramid_gap"], _pyr_gap(cap.pyr, ref_pyr))
        if control:
            c_rect = RI.rectify(raw, cam, torch.bfloat16)
            ctrl["rectify_gap"] = max(ctrl["rectify_gap"], _gap(c_rect, ref))
            c_pyr = RI.pyramid(_calibrated(c_rect, _after(c_chain, cap.n_fits)), levels)
            ctrl["pyramid_gap"] = max(ctrl["pyramid_gap"], _pyr_gap(c_pyr, ref_pyr))
        if not bool(cap.ok):
            n["rejected"] += 1      # the program discarded this answer itself
            continue
        n["judged"] += 1
        K0 = lens_K(cam)
        args = (K0, cap.exp_ref, cap.exp_new, cap.aff_ref, *cap.start, tracker, cap.coarsest,
                None if cap.min_res is None else cap.min_res.tolist())
        R, t, aff, _ = RT.track_coarse(cap.tpl, ref_pyr, *args, dtype=f64)
        px = RT.pose_gap_px(cap.tpl[0], K0, cap.R, cap.t, R, t)
        af = RT.affine_gap(cap.exp_ref, cap.exp_new, cap.aff_ref, cap.aff, aff)
        prog["track_px_gap"] = max(prog["track_px_gap"], px)
        prog["track_aff_gap"] = max(prog["track_aff_gap"], af)
        calls.append(dict(frame=idx, px=px, aff=af))
        if control:
            cR, ct, caff, _ = RT.track_coarse(cap.tpl, c_pyr, *args, dtype=torch.bfloat16)
            ctrl["track_px_gap"] = max(ctrl["track_px_gap"],
                                       RT.pose_gap_px(cap.tpl[0], K0, cR, ct, R, t))
            ctrl["track_aff_gap"] = max(ctrl["track_aff_gap"], RT.affine_gap(
                cap.exp_ref, cap.exp_new, cap.aff_ref, caff, aff))
    out = {"program": prog, "n": n, "calls": calls}
    if control:
        out["control"] = ctrl
    return out


def lens_K(cam) -> list:
    """The rectified camera's level-0 (fx, fy, cx, cy)."""
    K = cam.out_K
    return [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])]


def _calibrated(img, luts):
    if luts is None:
        return img
    inv_resp, inv_vig = luts[:2]
    return RI.photometric_correct(img, inv_resp, inv_vig)


def _refits(fits: List[Fit], raw_of, exp_of, cam, cfg: dict, device, dtype) -> list:
    """The reference's redo of each captured refit, in `dtype`, from its own
    rectification of each ring frame and from the program's previous fit,
    each blended into the reference's own previous correction: the
    correction in force after each."""
    W, H = cam.out_size
    out = []
    K = lens_K(cam)
    for fit in fits:
        frames = torch.stack([RI.rectify(raw_of(k).to(device), cam, dtype) for k in fit.frames])
        obs, r2, mask = RP.sample(fit.tpl, K, torch.as_tensor(fit.R, device=device),
                                  torch.as_tensor(fit.t, device=device), frames)
        exp = np.array([exp_of(k) for k in fit.frames], np.float64)
        known = bool(np.any(np.abs(exp - 1.0) > 1e-9))
        out.append(RP.refit(fit.before, out[-1] if out else None, obs, r2, mask,
                            torch.as_tensor(exp, dtype=dtype, device=device) if known else None,
                            cfg["photo_calib"], H, W))
    return out


def _after(corrections: list, n_fits: int):
    """The reference's correction in force once `n_fits` refits have landed
    (None before the first; None where a refit was not captured)."""
    if n_fits == 0:
        return None
    return corrections[n_fits - 1] if n_fits <= len(corrections) else None


def _correction_gap(a, b) -> float:
    """Largest difference of Binv(I) / V(x) between two corrections over
    intensities 0..255 and every CALIB_GRID-th pixel (grey levels)."""
    if a is None or b is None:
        return math.inf
    g = CALIB_GRID
    va = a[1][::g, ::g].reshape(-1).to(torch.float64)
    vb = b[1][::g, ::g].reshape(-1).to(va.device, torch.float64)
    ba = a[0].to(torch.float64)
    bb = b[0].to(va.device, torch.float64)
    return _gap(ba[:, None] * va[None, :], bb[:, None] * vb[None, :])


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
    return float(d) if bool(torch.isfinite(d)) else math.inf


def _pyr_gap(pa, pb) -> float:
    if len(pa) != len(pb):
        return math.inf
    return max(_gap(a, b) if a.shape == b.shape else math.inf for a, b in zip(pa, pb))


def verdict(readings: Dict[str, float], n: dict, limits: Dict[str, float]):
    """(correct, checks): every number the configuration limits within its
    limit, and enough calls (and, with calib_gap, refits) judged. `checks`
    maps each name to its reading and limit, in order."""
    held = [k for k in NUMBERS if k in limits]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in held}
    checks["judged_calls"] = {"value": n["judged"], "limit": MIN_JUDGED}
    ok = all(readings[k] <= limits[k] for k in held) and n["judged"] >= MIN_JUDGED
    if "calib_gap" in limits:
        checks["judged_fits"] = {"value": n["fits"], "limit": MIN_FITS}
        ok = ok and n["fits"] >= MIN_FITS
    return ok, checks
