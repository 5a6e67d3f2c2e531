"""Plain reference of the online photometric calibration: one refit from
the raw frames of the ring, and the correction it gives.

The stated model (H-SLAM's OnlineCalibrator, as the configuration's
`photo_calib` block sets it): an observation O of scene point k in frame i
at normalised radius r is O = G(e_i V(r) L_k). In log irradiance,
U(O) = log e_i + log V(r) + log L_k, with
- U = log o G^-1 piecewise linear over [0, 255] in `knots` cells, each
  cell's increment softplus(u_j) + 1e-4, U(255) = log 255 and a free span
  softplus(s) + 0.5 below it;
- V = 1 + a2 r^2 + a4 r^4 + a6 r^6, clamped to [0.1, 4];
- log e_0 = 0; L_k eliminated as the masked mean over the point's frames.
The fit is damped Gauss-Newton over [u (knots), s, a2, a4, a6, log e
(frames)] with the Jacobian taken by forward-mode differentiation
(torch.func.jacfwd), a step kept only where the squared residual falls.
Its extra rows: the smoothness of the log increments, a Tikhonov prior on
(a2, a4, a6), a prior toward the previous fit, and known exposures pinned.
From the fit: the response G as a 256-entry table (U^-1 rescaled to
[0, 255]), its numeric inverse Binv, and the inverse vignette map 1/V.
A later fit starts from the previous fit, is drawn toward it, and is
blended into the correction in force at the stated rate.

Everything runs in the dtype asked for: float64 for the reference,
bfloat16 for the control (its linear solve in float32). Nothing of the
program is imported.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import image as RI


class Params(NamedTuple):
    u: torch.Tensor         # (knots,) raw log increments
    span: torch.Tensor      # () raw span
    vig: torch.Tensor       # (3,) a2, a4, a6
    log_exp: torch.Tensor   # (F,) log exposures (entry 0 pinned to 0)


def initial(settings: dict, n_frames: int, dtype, device) -> Params:
    k = int(settings["knots"])
    return Params(torch.zeros(k, dtype=dtype, device=device),
                  torch.tensor(float(settings["init_span_raw"]), dtype=dtype, device=device),
                  torch.zeros(3, dtype=dtype, device=device),
                  torch.zeros(n_frames, dtype=dtype, device=device))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _flat(p: Params) -> torch.Tensor:
    return torch.cat([p.u, p.span.reshape(1), p.vig, p.log_exp])


def _unflat(x: torch.Tensor, k: int) -> Params:
    return Params(x[:k], x[k], x[k + 1:k + 4], x[k + 4:])


def response_log(p: Params, obs: torch.Tensor) -> torch.Tensor:
    """U(obs): observed intensity -> log irradiance."""
    k = p.u.shape[0]
    inc = _softplus(p.u) + 1e-4
    cum = torch.cat([inc.new_zeros(1), torch.cumsum(inc, 0)])
    cum = cum / cum[-1]
    x = torch.clamp(obs / 255.0, 0.0, 1.0) * k
    j = torch.clamp(torch.floor(x).long(), 0, k - 1)
    w = x - j.to(x.dtype)
    span = _softplus(p.span) + 0.5
    return math.log(255.0) - span + (cum[j] * (1 - w) + cum[j + 1] * w) * span


def vignette(p: Params, r2: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 + p.vig[0] * r2 + p.vig[1] * r2 ** 2 + p.vig[2] * r2 ** 3, 0.1, 4.0)


def sample(tpl, K, R: torch.Tensor, t: torch.Tensor, frames: torch.Tensor):
    """The template's level-0 points (u, v, idepth, valid) seen in each
    ring frame: relative poses (F, 3, 3), (F, 3) from the template's
    keyframe, frames (F, H, W). Returns obs, r2, mask as (P, F): the
    bilinear intensity, the squared radius normalised by the corner's, and
    whether the point is valid, in front and inside the frame's border."""
    dt = frames.dtype
    u, v, idepth, valid = (x.to(frames.device) for x in tpl)
    fx, fy, cx, cy = K
    ray = torch.stack([(u.to(dt) - cx) / fx, (v.to(dt) - cy) / fy, torch.ones_like(u, dtype=dt)])
    p = R.to(dt) @ ray + t.to(dt)[:, :, None] * idepth.to(dt)[None, None, :]     # (F, 3, P)
    z = p[:, 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    x = fx * p[:, 0] / z + cx
    y = fy * p[:, 1] / z + cy
    n, h, w = frames.shape
    inside = (z > 0) & (x > 1) & (y > 1) & (x < w - 2) & (y < h - 2)
    obs = torch.stack([RI.bilinear(frames[i], x[i], y[i]) for i in range(n)])
    ccx, ccy = (w - 1) / 2.0, (h - 1) / 2.0
    r2 = ((x - ccx) ** 2 + (y - ccy) ** 2) / (ccx ** 2 + ccy ** 2)
    mask = inside & valid.bool()[None, :] & torch.isfinite(obs)
    return obs.T, r2.T, mask.T


def fit(start: Params, obs, r2, mask, settings: dict, exposures: Optional[torch.Tensor],
        prev: Optional[Params]) -> Params:
    """The damped Gauss-Newton refit (see the module's docstring) from
    `start`, with the prior toward `prev` where there is one."""
    dt, dev = obs.dtype, obs.device
    k = start.u.shape[0]
    n_f = obs.shape[1]
    m = mask.to(dt)
    root_n = torch.sqrt(torch.clamp(m.sum(), min=1.0))
    smooth = float(settings["smoothness"])
    vig_w = torch.tensor(settings["vignette_prior"], dtype=dt, device=dev)
    prior = float(settings["prior_weight"])
    exp_w = float(settings["exposure_weight"])
    frame = torch.arange(n_f, device=dev)
    if exposures is not None:
        target = torch.log(torch.clamp(exposures.to(dt), min=1e-6))
        target = target - target[0]

    def residuals(x):
        p = _unflat(x, k)
        log_e = torch.where(frame == 0, torch.zeros_like(p.log_exp), p.log_exp)
        a = response_log(p, obs) - log_e[None, :] - torch.log(vignette(p, r2))
        radiance = (a * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        rows = [((a - radiance[:, None]) * m).reshape(-1)]
        log_inc = torch.log(_softplus(p.u) + 1e-4)
        rows += [smooth * root_n / k * (log_inc[1:] - log_inc[:-1]), vig_w * root_n * p.vig]
        if prev is not None:
            rows += [prior * root_n * (p.vig - prev.vig), prior * root_n / k * (p.u - prev.u)]
        if exposures is not None:
            rows.append(exp_w * root_n * (log_e - target))
        return torch.cat(rows)

    jac = torch.func.jacfwd(residuals)
    solve_dt = torch.float32 if dt == torch.bfloat16 else dt
    x = _flat(start)
    r = residuals(x)
    for _ in range(int(settings["iterations"])):
        J = jac(x)
        H = (J.T @ J).to(solve_dt)
        H = H + torch.diag(torch.clamp(torch.diagonal(H), min=1e-8)) * float(settings["damping"])
        step = torch.linalg.solve(H, (J.T @ r).to(solve_dt)).to(dt)
        x_new = x - step
        r_new = residuals(x_new)
        if bool((r_new * r_new).sum() < (r * r).sum()):
            x, r = x_new, r_new
    return _unflat(x, k)


def response_table(p: Params) -> torch.Tensor:
    """G: the 256-entry table from irradiance (rescaled to [0, 255]) to the
    observed intensity, the inverse of U's irradiance per level by a
    left-side search and linear interpolation."""
    levels = torch.arange(256, dtype=p.u.dtype, device=p.u.device)
    irr = torch.exp(response_log(p, levels))
    irr = (irr - irr[0]) / (irr[-1] - irr[0]) * 255.0
    i = torch.clamp(torch.searchsorted(irr.contiguous(), levels), 1, 255)
    lo, hi = irr[i - 1], irr[i]
    w = torch.where(hi > lo, (levels - lo) / torch.clamp(hi - lo, min=1e-9), torch.zeros_like(lo))
    return torch.clamp((i - 1).to(levels.dtype) + w, 0.0, 255.0)


def inverse_response(G: torch.Tensor) -> torch.Tensor:
    """Binv[i]: the x with G(x) = i, by a left-side search and linear
    interpolation between G's entries."""
    levels = torch.arange(256, dtype=G.dtype, device=G.device)
    i = torch.clamp(torch.searchsorted(G.contiguous(), levels) - 1, 0, 254)
    lo, hi = G[i], G[i + 1]
    w = torch.where(hi > lo, (levels - lo) / torch.clamp(hi - lo, min=1e-12), torch.zeros_like(lo))
    return torch.clamp(i.to(G.dtype) + w, 0.0, 255.0)


def correction(p: Params, height: int, width: int):
    """(Binv (256,), 1/V (height, width)) of a fit."""
    dt, dev = p.u.dtype, p.u.device
    ys = torch.arange(height, dtype=dt, device=dev)[:, None]
    xs = torch.arange(width, dtype=dt, device=dev)[None, :]
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    r2 = ((xs - cx) ** 2 + (ys - cy) ** 2) / (cx * cx + cy * cy)
    return inverse_response(response_table(p)), 1.0 / vignette(p, r2)


def refit(before: Optional[Params], in_force: Optional[tuple], obs, r2, mask,
          exposures: Optional[torch.Tensor], settings: dict, height: int, width: int):
    """One online refit and the correction in force after it. `before` is
    the previous fit (None for the first): the refit starts from it, with
    its log exposures zeroed, and is drawn toward it. `in_force` is the
    correction the previous fits left: a later fit is blended into it at
    the stated rate; the first fit's correction is taken whole."""
    dt = obs.dtype
    n_f = obs.shape[1]
    if before is None:
        start, prev = initial(settings, n_f, dt, obs.device), None
    else:
        prev = Params(*(x.to(obs.device, dt) for x in before))
        start = prev._replace(log_exp=prev.log_exp.new_zeros(n_f))
    new = correction(fit(start, obs, r2, mask, settings, exposures, prev), height, width)
    if in_force is None:
        return new
    a = float(settings["blend"])
    return tuple((1 - a) * old.to(obs.device, dt) + a * x for old, x in zip(in_force, new))
