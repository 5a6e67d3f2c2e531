"""The online photometric calibration: every refit of the run held against
the reference's redo of it.

Capture. From the moment the system is built, the system's refit
(`SLAMSystem._photo_calib_step`) is wrapped: each refit that lands is
captured with the frames of the ring, their poses relative to the
template's keyframe, the template's level-0 points the program sampled
them at, and the program's previous fit, all read just before it runs, and
the correction the program put in force once it has landed.

Judgement, after the window:
- calib_gap: the reference redoes each refit (reference/photo_calib.py)
  from its own rectification of the raw frames and the handed-over
  exposures, starting from the program's previous fit as the program does
  (the first from the stated initial values), and blends it into its own
  previous correction; the reading is the largest difference, over the
  refits, intensities 0..255 and a grid of pixels, of the corrected
  intensity Binv(I) / V(x) (grey levels). A refit the program numbers out
  of turn reads inf.
`judged_fits` counts the refits judged. The control redoes the refits in
bfloat16. The reference's corrections in force after each refit, and the
control's, are left for the tracking judge's pyramid reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from slambench.judge import Judged, gap, lens_K
from slambench.reference import image as RI
from slambench.reference import photo_calib as RP

NUMBERS = ("calib_gap",)
MINIMUMS = {"judged_fits": 3}       # fewer refits in a calibrating run: the fits never came
AFTER = ()
SCOPE = "run"
CALIB_GRID = 4           # calib_gap reads every CALIB_GRID-th pixel in each direction


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
    def __init__(self, ctx):
        self.system = ctx.system
        self.rate = ctx.rate
        self.captured: List[Fit] = []

    def install(self):
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
                self.captured.append(Fit(frames, rel[:, :3, :3], rel[:, :3, 3], lv0, before,
                                         slam._pc_luts, slam.n_photo_fits))
            return landed
        slam._photo_calib_step = captured

    def remove(self):
        self.system.__dict__.pop("_photo_calib_step", None)


def judge(captured: List[Fit], inputs, state, control) -> Judged:
    chain = _refits(captured, inputs, torch.float64)
    c_chain = _refits(captured, inputs, torch.bfloat16) if control else None
    prog, ctrl, rows = 0.0, 0.0, []
    for k, fit in enumerate(captured):
        g = math.inf if fit.n != k + 1 else _correction_gap(fit.luts, chain[k])
        prog = max(prog, g)
        rows.append(dict(fit=fit.n, gap=g))
        if control:
            ctrl = max(ctrl, _correction_gap(c_chain[k], chain[k]))
    return Judged({"calib_gap": prog}, {"judged_fits": len(captured)}, rows,
                  {"calib_gap": ctrl} if control else None,
                  {"corrections": chain, "control": c_chain})


def _refits(fits: List[Fit], inputs, dtype) -> list:
    """The reference's redo of each captured refit, in `dtype`, from its own
    rectification of each ring frame and from the program's previous fit,
    each blended into the reference's own previous correction: the
    correction in force after each."""
    cam, device = inputs.lens, inputs.device
    W, H = cam.out_size
    out = []
    K = lens_K(cam)
    for fit in fits:
        frames = torch.stack([RI.rectify(inputs.raw_of(k).to(device), cam, dtype)
                              for k in fit.frames])
        obs, r2, mask = RP.sample(fit.tpl, K, torch.as_tensor(fit.R, device=device),
                                  torch.as_tensor(fit.t, device=device), frames)
        exp = np.array([inputs.exp_of(k) for k in fit.frames], np.float64)
        known = bool(np.any(np.abs(exp - 1.0) > 1e-9))
        out.append(RP.refit(fit.before, out[-1] if out else None, obs, r2, mask,
                            torch.as_tensor(exp, dtype=dtype, device=device) if known else None,
                            inputs.cfg["photo_calib"], H, W))
    return out


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
    return gap(ba[:, None] * va[None, :], bb[:, None] * vb[None, :])
