"""Drive the port's building blocks on a synthetic two-frame scene
(counterpart of scripts/drive_synthetic.py), with the JAX script's checks:

  1. the direct pyramids of both frames;
  2. a tracking template on frame 0 (points at the plane's true depth) and
     the coarse tracker from the identity: the pose error must fall below
     a tenth of the true motion's;
  3. one windowed BA of 6 iterations on a 4-frame window of the plane from
     perturbed states: its rmse must be finite.

Usage:
    python -m hslam_tpu_torch.tools.drive_synthetic [--device cpu]

The texture (6 sinusoids) and the random points and perturbations come
from numpy (the JAX script's jax.random draws cannot be reproduced in
torch). Times: the first call and a second one, host clock to a
synchronised device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import PATTERN, Config
from ..models import window as W
from ..models.calib import k_pyr_from_value, make_calib
from ..models.optimizer import ba_optimize
from ..ops import tracker as trk
from ..ops.pyramid import build_direct_pyramid, image_gradients
from ..utils import lie
from ..utils.interp import bilinear

H, WD = 240, 320
FX = FY = 150.0
CX, CY = WD / 2 - 0.5, H / 2 - 0.5
DEPTH = 2.0
XI_GT = [0.06, -0.03, 0.02, 0.01, -0.008, 0.004]
WINDOW_XI = [[0.0] * 6, XI_GT, [-0.05, 0.02, 0.01, -0.006, 0.004, 0.01],
             [0.02, 0.06, -0.02, 0.004, 0.01, -0.006]]


def smooth_image(rng: np.random.Generator, h: int, w: int, device) -> torch.Tensor:
    ky, kx = rng.uniform(0.5, 4.5, (2, 6))
    phases = rng.uniform(0.0, 1.0, 6) * 6.28
    amps = [40.0, 30.0, 20.0, 15.0, 10.0, 8.0]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return 120.0 + sum(amps[i] * torch.sin(2 * np.pi * (float(kx[i]) * xs / w
                                                        + float(ky[i]) * ys / h) + float(phases[i]))
                       for i in range(6))


def render(I0: torch.Tensor, Rf: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
    """The plane at DEPTH seen by the camera with worldToCam (Rf, tf)."""
    dev = I0.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(WD, dtype=torch.float32, device=dev), indexing="ij")
    px, py = (xs - CX) / FX, (ys - CY) / FY
    Rinv, tinv = lie.se3_inverse(Rf, tf)
    dz = Rinv[2, 0] * px + Rinv[2, 1] * py + Rinv[2, 2]
    s = (DEPTH - tinv[2]) / dz
    X = s * (Rinv[0, 0] * px + Rinv[0, 1] * py + Rinv[0, 2]) + tinv[0]
    Y = s * (Rinv[1, 0] * px + Rinv[1, 1] * py + Rinv[1, 2]) + tinv[1]
    return bilinear(I0, FX * X / DEPTH + CX, FY * Y / DEPTH + CY)


def _timed(fn, dev):
    """(result, first call ms, second call ms), synchronised."""
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, ms[0], ms[1]


def run(device="cuda") -> dict:
    """The three checks; raises AssertionError if one fails. Returns the
    numbers it prints."""
    dev = torch.device(device)
    cfg = Config(max_frames=4, max_points=512, pyr_levels=4)
    calib = make_calib(FX, FY, CX, CY, WD, H, device=dev)
    rng = np.random.default_rng(7)
    I0 = smooth_image(rng, H, WD, dev)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    xi_gt = f32(XI_GT)
    R_gt, t_gt = lie.se3_exp(xi_gt)
    I1 = render(I0, R_gt, t_gt)

    (pyr0, _), ms0, _ = _timed(lambda: build_direct_pyramid(I0, cfg.pyr_levels), dev)
    pyr1, _ = build_direct_pyramid(I1, cfg.pyr_levels)
    shapes = [tuple(p.shape) for p in pyr0]
    print(f"[1] pyramids built in {ms0:.1f} ms; levels: {shapes}")

    # the tracker: a template of points at the plane's true depth in frame 0
    P = cfg.max_points
    u = f32(rng.uniform(5.0, WD - 5.0, P))
    v = f32(rng.uniform(5.0, H - 5.0, P))
    tmpl = trk.build_template(u, v, torch.full((P,), 1.0 / DEPTH, device=dev),
                              torch.ones(P, device=dev), torch.ones(P, dtype=torch.bool, device=dev),
                              pyr0)
    K_pyr = k_pyr_from_value(calib.value, cfg.pyr_levels)
    eye, zero3, zero2, one = (torch.eye(3, device=dev), torch.zeros(3, device=dev),
                              torch.zeros(2, device=dev), torch.ones((), device=dev))
    res, ms_first, ms_run = _timed(lambda: trk.track_coarse(
        tmpl, pyr1, K_pyr, eye, zero3, zero2, one, one, zero2, cfg), dev)
    err0 = float(torch.linalg.norm(xi_gt))
    dR, dt = lie.se3_mul(res.R, res.t, *lie.se3_inverse(R_gt, t_gt))
    err1 = float(torch.linalg.norm(lie.se3_log(dR, dt)))
    print(f"[2] tracker: pose error {err0:.4f} -> {err1:.6f} (ok={bool(res.ok)}, "
          f"rmse L0={float(res.residuals[0]):.2f}), first call {ms_first:.1f} ms, "
          f"run {ms_run:.1f} ms")
    assert err1 < 0.1 * err0, "tracker did not converge"

    # windowed BA on a 4-frame window of the plane
    F = cfg.max_frames
    R_all, t_all = lie.se3_exp(f32(WINDOW_XI))
    images = []
    for f in range(F):
        If = render(I0, R_all[f], t_all[f])
        dx, dy = image_gradients(If)
        images.append(torch.stack([If, dx, dy], -1))
    wnd = W.empty_window(cfg, H, WD, device=dev)
    pert = rng.normal(size=(F, 8)) * np.array([0.01] * 3 + [0.005] * 3 + [0.0, 0.0])
    pert[0] = 0.0
    frames = wnd.frames._replace(
        valid=torch.ones(F, dtype=torch.bool, device=dev), evalpt_R=R_all, evalpt_t=t_all,
        kf_id=torch.arange(F, dtype=torch.int32, device=dev), images=torch.stack(images),
        prior=f32([W.first_frame_prior(cfg)] + [W.later_frame_prior(cfg)] * (F - 1)),
        state=f32(pert))
    pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=dev)
    up, vp = u[:, None] + pat[None, :, 0], v[:, None] + pat[None, :, 1]
    inv_d = torch.full((P,), 1.0 / DEPTH, device=dev)
    points = wnd.points._replace(
        status=torch.ones(P, dtype=torch.int32, device=dev),
        host=torch.zeros(P, dtype=torch.int32, device=dev), u=u, v=v, idepth=inv_d,
        idepth_zero=inv_d.clone(), color=bilinear(images[0][..., 0], up, vp),
        weight=torch.ones((P, 8), device=dev))
    wnd = W.Window(frames=frames, points=points, HM=wnd.HM, bM=wnd.bM)
    out, ms_first_ba, ms_ba = _timed(lambda: ba_optimize(wnd, calib, cfg, 6), dev)
    rmse = float(out.rmse)
    after = float(torch.linalg.norm(out.window.frames.state[:, :6]))
    print(f"[3] BA: rmse={rmse:.3f}, state norm before={float(np.linalg.norm(pert)):.4f} "
          f"after(delta vs evalPT)={after:.4f}, first call {ms_first_ba:.1f} ms, "
          f"run {ms_ba:.1f} ms")
    assert np.isfinite(rmse), "BA produced non-finite energy"
    print("DRIVE OK")
    return dict(pyramid_shapes=shapes, err0=err0, err1=err1, track_ok=bool(res.ok),
                ba_rmse=rmse, track_ms=ms_run, ba_ms=ms_ba)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", type=str, default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
