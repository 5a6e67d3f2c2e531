"""Online photometric calibration: joint response / vignette / exposure
(port of hslam_tpu/models/photo_calib.py).

The reference declares this capability and ships it commented out
(Include/OnlineCalibrator.h:13-67); the live hook points are the
PhotoUnDistMode::OnlineCalib enum and PhotometricUndistorter::UpdateGamma
(photometricUndistorter.cpp:175-200).

Model: O_ik = G(e_i * V(r_ik) * L_k) for observation O of scene point k in
frame i at normalized radius r; in log-irradiance space with U = log o G^-1,
U(O_ik) = log e_i + log V(r_ik) + log L_k.
  * U: monotone piecewise-linear over [0, 255], softplus-positive
    increments over `n_knots`, a free span, U(255) = log(255) pinned;
  * V: even radial polynomial 1 + a2 r^2 + a4 r^4 + a6 r^6;
  * e_i: per-frame log exposures, frame 0 pinned to 1; L_k eliminated in
    closed form per point.
`calibrate` runs Gauss-Newton with Levenberg-style damping over the flat
vector [u_raw (n_knots), u_span_raw (1), vig (3), log_exp (F)], its
Jacobian written out (the JAX package's `jax.jacfwd`; the tests hold it to
`torch.func.jacfwd`), a step taken only where the error falls, decided on
the device: no host sync.

softplus is log(1 + e^x) as `torch.logaddexp(x, 0)`, JAX's definition
(`torch.nn.functional.softplus` switches to x above 20).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class PhotoParams(NamedTuple):
    u_raw: torch.Tensor       # (n_knots,) raw increments of U (softplus'd)
    u_span_raw: torch.Tensor  # () raw log-irradiance span of U (softplus'd)
    vig: torch.Tensor         # (3,) [a2, a4, a6]
    log_exp: torch.Tensor     # (F,) per-frame log exposure (frame 0 pinned)


def init_params(n_frames: int, n_knots: int = 16, device="cuda") -> PhotoParams:
    return PhotoParams(
        u_raw=torch.zeros(n_knots, device=device),
        u_span_raw=torch.tensor(5.96, device=device),   # softplus ~ 5.96 -> span ~ 6.5
        vig=torch.zeros(3, device=device),
        log_exp=torch.zeros(n_frames, device=device),
    )


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _pin_first(log_exp: torch.Tensor) -> torch.Tensor:
    """log_exp with entry 0 set to 0 (the gauge e_0 = 1), built without an
    in-place write, so its column of the Jacobian is exactly zero."""
    return torch.cat([log_exp.new_zeros(1), log_exp[1:]])


def _U(params: PhotoParams, obs: torch.Tensor) -> torch.Tensor:
    """Monotone map observed intensity [0, 255] -> log irradiance. U(255) =
    log(255) is the gauge pin; U(0) = log(255) - span with the span free (a
    fixed span would impose an arbitrary response scale, the gamma-ambiguity
    direction)."""
    n = params.u_raw.shape[-1]
    inc = _softplus(params.u_raw) + 1e-4
    csum = torch.cat([inc.new_zeros(1), torch.cumsum(inc, 0)])
    csum = csum / csum[-1]
    x = torch.clamp(obs / 255.0, 0.0, 1.0) * n
    i0 = torch.clamp(torch.floor(x).long(), 0, n - 1)
    frac = x - i0.to(x.dtype)
    u01 = csum[i0] * (1 - frac) + csum[i0 + 1] * frac
    span = _softplus(params.u_span_raw) + 0.5
    return (math.log(255.0) - span) + u01 * span


def _log_vignette(params: PhotoParams, r2: torch.Tensor) -> torch.Tensor:
    a2, a4, a6 = params.vig[0], params.vig[1], params.vig[2]
    v = 1.0 + a2 * r2 + a4 * r2 * r2 + a6 * r2 * r2 * r2
    # [0.1, 4]: physical lens falloff stays inside; the clamp bounds the
    # damage of a correction if the fit still overshoots
    return torch.log(torch.clamp(v, 0.1, 4.0))


def residuals(params: PhotoParams, obs: torch.Tensor, frame_idx: torch.Tensor,
              r2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """obs: (P, F) tracked-point intensities; frame_idx: (P, F) or (F,)
    frame of each column; r2: (P, F) normalized radius^2; mask: (P, F)
    observation validity. Returns the masked residuals (P, F): U(O) - log e
    - log V, minus its masked mean over frames (radiance eliminated)."""
    le = _pin_first(params.log_exp)
    x = _U(params, obs) - le[frame_idx] - _log_vignette(params, r2)
    m = mask.to(x.dtype)
    L = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
    return (x - L[:, None]) * m


def _flatten(params: PhotoParams) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in params])


def _unflatten(flat: torch.Tensor, n_knots: int) -> PhotoParams:
    return PhotoParams(u_raw=flat[:n_knots], u_span_raw=flat[n_knots],
                       vig=flat[n_knots + 1:n_knots + 4], log_exp=flat[n_knots + 4:])


def _gn_functions(n_knots: int, n_frames: int, obs, frame_idx, r2, mask, smooth_w: float,
                  vig_w: tuple, exp_known, prev: Optional[PhotoParams], prev_w: float):
    """The residual vector of `calibrate` over the flat parameters and its
    Jacobian, written out (the JAX package takes it by forward-mode AD; here
    that costs ~1,900 dispatched ops a Gauss-Newton iteration against ~30).
    Returns (residual(p) (M,), jacobian(p) (M, K), the observation count)."""
    dt, dev = r2.dtype, r2.device
    n, K = n_knots, n_knots + 4 + n_frames
    m = mask.to(dt)
    n_mask = torch.clamp(torch.sum(m), min=1.0)
    n_obs = torch.sqrt(n_mask)
    vig_wv = torch.tensor(vig_w, dtype=dt, device=dev)
    if exp_known is not None:
        le_t = torch.log(torch.clamp(exp_known.to(dt), min=1e-6))
        le_t = le_t - le_t[0]

    def res_flat(p):
        pp = _unflatten(p, n)
        data = residuals(pp, obs, frame_idx, r2, mask).reshape(-1)
        log_inc = torch.log(_softplus(pp.u_raw) + 1e-4)
        parts = [data, smooth_w * (n_obs / n) * (log_inc[1:] - log_inc[:-1]),
                 vig_wv * n_obs * pp.vig]
        if prev is not None:
            parts += [prev_w * n_obs * (pp.vig - prev.vig),
                      prev_w * (n_obs / n) * (pp.u_raw - prev.u_raw)]
        if exp_known is not None:
            parts.append(10.0 * n_obs * (_pin_first(pp.log_exp) - le_t))
        return torch.cat(parts)

    # what the parameters do not change: each observation's knot cell (the
    # weights of the knots below, at and above it), its radius powers, its
    # frame as a one-hot over the exposures (none for the pinned frame 0),
    # the masked mean over a point's frames, and the Tikhonov rows
    x = torch.clamp(obs / 255.0, 0.0, 1.0) * n
    i0 = torch.clamp(torch.floor(x).long(), 0, n - 1)
    frac = x - i0.to(dt)
    knots = torch.arange(n, device=dev)
    step = (knots < i0[..., None]).to(dt) + (knots == i0[..., None]).to(dt) * frac[..., None]
    rpow = torch.stack([r2, r2 * r2, r2 * r2 * r2], -1)
    frames = torch.arange(n_frames, device=dev)
    d_le = -torch.broadcast_to((frame_idx[..., None] == frames) & (frames > 0),
                               obs.shape + (n_frames,)).to(dt)
    count = torch.clamp(torch.sum(m, 1), min=1.0)[:, None, None]
    sq = torch.eye(n, dtype=dt, device=dev)
    diff = (sq[1:] - sq[:-1]) * (smooth_w * n_obs / n)          # log_inc[j+1] - log_inc[j]
    eye = torch.eye(K, dtype=dt, device=dev)
    fixed = [vig_wv[:, None] * n_obs * eye[n + 1:n + 4]]
    if prev is not None:
        fixed += [prev_w * n_obs * eye[n + 1:n + 4], prev_w * (n_obs / n) * eye[:n]]
    if exp_known is not None:
        fixed.append(10.0 * n_obs * eye[n + 4:] * (frames > 0).to(dt)[:, None])
    fixed = torch.cat(fixed)

    def jac_flat(p):
        pp = _unflatten(p, n)
        inc = _softplus(pp.u_raw) + 1e-4
        C = torch.cumsum(inc, 0)
        csum = torch.cat([inc.new_zeros(1), C]) / C[-1]
        u01 = csum[i0] * (1 - frac) + csum[i0 + 1] * frac
        span = _softplus(pp.u_span_raw) + 0.5
        sig_u = torch.sigmoid(pp.u_raw)
        # U = log(255) - span + u01 * span with u01 the normalized cumulative
        # increments at the observation: dU/du_j = span sigmoid(u_j) / C_n
        # (step_j - u01), dU/ds = (u01 - 1) sigmoid(s)
        d_u = (span * sig_u / C[-1]) * (step - u01[..., None])
        d_s = (u01 - 1.0) * torch.sigmoid(pp.u_span_raw)
        a = pp.vig
        v = 1.0 + a[0] * r2 + a[1] * r2 * r2 + a[2] * r2 * r2 * r2
        d_v = -rpow * (((v >= 0.1) & (v <= 4.0)).to(dt) / v)[..., None]   # through the clamp
        Jx = torch.cat([d_u, d_s[..., None], d_v, d_le], -1)              # (P, F, K)
        Jd = m[..., None] * (Jx - torch.sum(m[..., None] * Jx, 1, keepdim=True) / count)
        smooth = torch.cat([diff * (sig_u / inc), diff.new_zeros((n - 1, K - n))], 1)
        return torch.cat([Jd.reshape(-1, K), smooth, fixed])

    return res_flat, jac_flat, n_mask


def calibrate(params: PhotoParams, obs: torch.Tensor, frame_idx: torch.Tensor,
              r2: torch.Tensor, mask: torch.Tensor, n_iters: int = 20,
              lam: float = 1e-4, smooth_w: float = 0.3,
              exp_known: Optional[torch.Tensor] = None,
              vig_w: tuple = (0.02, 0.2, 2.0),
              prev: Optional[PhotoParams] = None, prev_w: float = 0.5):
    """Joint GN over (u_raw, u_span_raw, vig, log_exp). Returns the updated
    params and the final data-residual RMS (a device scalar).

    `smooth_w` pulls the response's log-increments toward uniformity (else a
    near-degenerate minimum flattens the response and zeroes the exposures).
    `vig_w` Tikhonov-regularizes (a2, a4, a6) with graduated weights on the
    sqrt(n_obs) scale of the data: one window's observations cover a narrow
    radius band, outside which the free polynomial runs away. `prev` adds a
    weak prior toward the previous refit's response and vignette, so
    successive online refits cannot oscillate. `exp_known` ((F,) exposure
    times) pins the log exposures to the telemetry relative to frame 0,
    which breaks the gamma ambiguity of unknown exposures."""
    n_knots = params.u_raw.shape[0]
    flat = _flatten(params)
    res_flat, jac_flat, n_mask = _gn_functions(
        n_knots, params.log_exp.shape[0], obs, frame_idx, r2, mask, smooth_w, vig_w, exp_known,
        prev, prev_w)
    n_data = obs.numel()
    rms = torch.zeros((), dtype=flat.dtype, device=flat.device)
    r = res_flat(flat)
    for _ in range(n_iters):
        J = jac_flat(flat)
        H = J.T @ J
        H = H + torch.diag(torch.clamp(torch.diagonal(H), min=1e-8)) * lam
        dp, _ = torch.linalg.solve_ex(H, J.T @ r)
        p_new = flat - dp
        r_new = res_flat(p_new)
        better = torch.sum(r_new * r_new) < torch.sum(r * r)
        flat = torch.where(better, p_new, flat)
        r = torch.where(better, r_new, r)
        rms = torch.sqrt(torch.sum(r[:n_data] ** 2) / n_mask)
    return _unflatten(flat, n_knots), rms


def gamma_lut(params: PhotoParams) -> torch.Tensor:
    """The response G as a 256-entry LUT from irradiance index to observed
    intensity, the format PhotometricUndistorter::UpdateGamma consumes
    (photometricUndistorter.cpp:175-200): G = U^-1 rescaled to [0, 255]."""
    levels = torch.arange(256, dtype=params.u_raw.dtype, device=params.u_raw.device)
    irr = torch.exp(_U(params, levels))          # irradiance per observed level
    irr = (irr - irr[0]) / (irr[-1] - irr[0]) * 255.0
    # G maps irradiance -> observed: invert the monotone table (left side)
    idx = torch.clamp(torch.searchsorted(irr.contiguous(), levels), 1, 255)
    lo = irr[idx - 1]
    hi = irr[idx]
    frac = torch.where(hi > lo, (levels - lo) / torch.clamp(hi - lo, min=1e-9),
                       torch.zeros_like(levels))
    return torch.clamp((idx - 1).to(levels.dtype) + frac, 0.0, 255.0)


def vignette_map(params: PhotoParams, height: int, width: int) -> torch.Tensor:
    """Dense V(x) map (height, width) for the correction."""
    dev = params.vig.device
    ys = torch.arange(height, device=dev)[:, None]
    xs = torch.arange(width, device=dev)[None, :]
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    r2 = ((xs - cx) ** 2 + (ys - cy) ** 2) / (cx * cx + cy * cy)
    return torch.exp(_log_vignette(params, r2))
