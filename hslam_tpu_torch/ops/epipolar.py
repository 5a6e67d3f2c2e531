"""Batched epipolar depth tracing of candidate (immature) points (port of
hslam_tpu/ops/epipolar.py: ImmaturePoint::traceOn for all candidates at
once).

A stride-2 discrete search along the epipolar line, a +-1 refinement of the
winner, `trace_gn_iterations` masked GN steps along the line (a fixed-count
Python loop, no host sync) and the inverse-depth interval update. Status
machine GOOD / OOB / OUTLIER / SKIPPED / BADCONDITION / UNINITIALIZED, OOB
sticky, a second OUTLIER escalating to OOB.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PATTERN, Config
from ..utils.interp import bilinear_packed, pack_cells

IPS_GOOD = 0
IPS_OOB = 1
IPS_OUTLIER = 2
IPS_SKIPPED = 3
IPS_BADCONDITION = 4
IPS_UNINITIALIZED = 5


class TraceState(NamedTuple):
    idepth_min: torch.Tensor
    idepth_max: torch.Tensor    # +inf when uninitialized
    status: torch.Tensor        # int32
    quality: torch.Tensor
    last_u: torch.Tensor
    last_v: torch.Tensor
    last_interval: torch.Tensor


def init_trace_state(n: int, device="cuda") -> TraceState:
    f32 = dict(dtype=torch.float32, device=device)
    return TraceState(
        idepth_min=torch.zeros(n, **f32),
        idepth_max=torch.full((n,), float("inf"), **f32),
        status=torch.full((n,), IPS_UNINITIALIZED, dtype=torch.int32, device=device),
        quality=torch.full((n,), 10000.0, **f32),
        last_u=torch.full((n,), -1.0, **f32),
        last_v=torch.full((n,), -1.0, **f32),
        last_interval=torch.zeros(n, **f32),
    )


def _huber_w(a, th):
    return torch.where(a < th, torch.ones_like(a), th / torch.clamp(a, min=1e-12))


def trace_on(state: TraceState, u, v, color, weights, gradH, energy_th,
             point_valid, KRKi, Kt, affine, target: torch.Tensor,
             cfg: Config) -> TraceState:
    """One trace pass of all candidates against a new frame.
    KRKi (P, 3, 3), Kt (P, 3), affine (P, 2): per-candidate host->new warp."""
    Himg, Wimg = target.shape[0], target.shape[1]
    P = u.shape[0]
    dev = u.device
    max_pix_search = (Wimg + Himg) * cfg.max_pix_search
    where = torch.where

    skip = (state.status == IPS_OOB) | ~point_valid
    uv1 = torch.stack([u, v, torch.ones_like(u)], -1)
    pr = (KRKi @ uv1[..., None])[..., 0]
    ptp_min = pr + Kt * state.idepth_min[:, None]
    u_min = ptp_min[:, 0] / ptp_min[:, 2]
    v_min = ptp_min[:, 1] / ptp_min[:, 2]

    def inb(x, y):
        return (x > 4) & (y > 4) & (x < Wimg - 5) & (y < Himg - 5)

    oob = ~inb(u_min, v_min)
    has_max = torch.isfinite(state.idepth_max)
    id_max_eff = where(has_max, state.idepth_max, torch.full_like(u, 0.01))
    ptp_max = pr + Kt * id_max_eff[:, None]
    u_max = ptp_max[:, 0] / ptp_max[:, 2]
    v_max = ptp_max[:, 1] / ptp_max[:, 2]

    dist_known = torch.sqrt((u_min - u_max) ** 2 + (v_min - v_max) ** 2)
    dxy_n = 1.0 / torch.clamp(dist_known, min=1e-12)
    u_max = where(has_max, u_max, u_min + max_pix_search * (u_max - u_min) * dxy_n)
    v_max = where(has_max, v_max, v_min + max_pix_search * (v_max - v_min) * dxy_n)
    dist = where(has_max, dist_known, torch.full_like(u, max_pix_search))

    oob = oob | ~inb(u_max, v_max)
    oob = oob | ~((state.idepth_min < 0)
                  | ((ptp_min[:, 2] > 0.75) & (ptp_min[:, 2] < 1.5)))
    skipped = has_max & (dist < cfg.trace_slack_interval)

    dx = cfg.trace_step_size * (u_max - u_min)
    dy = cfg.trace_step_size * (v_max - v_min)
    e = torch.stack([dx, dy], -1)
    e_perp = torch.stack([dy, -dx], -1)
    a = torch.sum(e[:, :, None] * gradH * e[:, None, :], dim=(1, 2))
    b = torch.sum(e_perp[:, :, None] * gradH * e_perp[:, None, :], dim=(1, 2))
    error_in_pixel = 0.2 + 0.2 * (a + b) / torch.clamp(a, min=1e-12)
    badcond = (error_in_pixel * cfg.trace_min_improvement_factor > dist) & has_max
    error_in_pixel = torch.clamp(error_in_pixel, max=10.0)

    dxn = dx / torch.clamp(dist, min=1e-12)
    dyn = dy / torch.clamp(dist, min=1e-12)
    oob = oob | ~torch.isfinite(dxn) | ~torch.isfinite(dyn)
    over = dist > max_pix_search
    u_max = where(over, u_min + max_pix_search * dxn, u_max)
    v_max = where(over, v_min + max_pix_search * dyn, v_max)
    dist = torch.clamp(dist, max=max_pix_search)

    n_steps = torch.clamp((1.9999 + dist / cfg.trace_step_size).to(torch.int32),
                          max=cfg.trace_max_steps - 1)
    n_steps_f = n_steps.float()

    rand_shift = u_min * 1000.0 - torch.floor(u_min * 1000.0)
    ptx0 = u_min - rand_shift * dxn
    pty0 = v_min - rand_shift * dyn

    pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=dev)
    Rp = KRKi[:, :2, :2]
    rot_pat = torch.einsum("pij,kj->pki", Rp, pat)                 # (P, 8, 2)

    S = (cfg.trace_max_steps + 1) // 2
    steps = torch.arange(S, dtype=torch.float32, device=dev)
    px = ptx0[:, None] + (steps[None, :] * 2.0) * dxn[:, None]
    py = pty0[:, None] + (steps[None, :] * 2.0) * dyn[:, None]
    packed = pack_cells(target[:, :, 0])

    def ssd_at(px_, py_):
        sx = px_[..., None] + rot_pat[:, None, :, 0]
        sy = py_[..., None] + rot_pat[:, None, :, 1]
        hit = bilinear_packed(packed, sx, sy)
        r = hit - (affine[:, None, None, 0] * color[:, None, :] + affine[:, None, None, 1])
        hw = _huber_w(r.abs(), cfg.huber_th)
        return torch.sum(hw * r * r * (2.0 - hw), dim=-1)

    big = torch.tensor(1e10, device=dev)
    energies = ssd_at(px, py)
    steps_px = steps * 2.0
    step_valid = steps_px[None, :] < n_steps_f[:, None]
    energies = where(step_valid, energies, big)
    best_energy, best_i2 = energies.min(dim=-1)
    best_step = best_i2.float() * 2.0

    ref_steps = torch.stack([best_step - 1.0, best_step + 1.0], -1)
    ref_valid = (ref_steps >= 0) & (ref_steps < n_steps_f[:, None])
    rx = ptx0[:, None] + ref_steps * dxn[:, None]
    ry = pty0[:, None] + ref_steps * dyn[:, None]
    ref_E = where(ref_valid, ssd_at(rx, ry), big)
    all_E = torch.cat([best_energy[:, None], ref_E], -1)
    all_steps = torch.cat([best_step[:, None], ref_steps], -1)
    best_energy, pick = all_E.min(dim=-1)
    best_step = torch.gather(all_steps, 1, pick[:, None])[:, 0]
    best_u = ptx0 + best_step * dxn
    best_v = pty0 + best_step * dyn

    idxs = steps_px[None, :]
    outside = (idxs < best_step[:, None] - 2.0) | (idxs > best_step[:, None] + 2.0)
    second = where(outside & step_valid, energies, big).min(dim=-1).values
    new_quality = second / torch.clamp(best_energy, min=1e-12)
    quality = where((new_quality < state.quality) | (n_steps > 10), new_quality, state.quality)

    # GN refinement along the line (ImmaturePoint.cpp:245-305)
    flat3 = target.reshape(-1, 3)
    bu, bv = best_u, best_v
    bE = torch.full((P,), 1e5, device=dev)
    ubak, vbak = best_u, best_v
    step_back = torch.zeros(P, device=dev)
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    for _ in range(cfg.trace_gn_iterations):
        gx = bu[:, None] + rot_pat[:, :, 0]
        gy = bv[:, None] + rot_pat[:, :, 1]
        xc = torch.clamp(gx, 0.0, Wimg - 1.0)
        yc = torch.clamp(gy, 0.0, Himg - 1.0)
        ix = torch.clamp(torch.floor(xc).long(), 0, Wimg - 2)
        iy = torch.clamp(torch.floor(yc).long(), 0, Himg - 2)
        fx_ = (xc - ix)[..., None]
        fy_ = (yc - iy)[..., None]
        base = iy * Wimg + ix
        hit3 = ((flat3[base] * (1 - fx_) + flat3[base + 1] * fx_) * (1 - fy_)
                + (flat3[base + Wimg] * (1 - fx_) + flat3[base + Wimg + 1] * fx_) * fy_)
        res = hit3[..., 0] - (affine[:, None, 0] * color + affine[:, None, 1])
        dres = dxn[:, None] * hit3[..., 1] + dyn[:, None] * hit3[..., 2]
        hw = _huber_w(res.abs(), cfg.huber_th)
        Hgn = 1.0 + torch.sum(hw * dres * dres, dim=-1)
        bgn = torch.sum(hw * res * dres, dim=-1)
        energy = torch.sum(weights * weights * hw * res * res * (2.0 - hw), dim=-1)

        worse = energy > bE
        sb_worse = step_back * 0.5
        step = torch.clamp(-bgn / Hgn, -0.5, 0.5)
        step = where(torch.isfinite(step), step, torch.zeros_like(step))
        upd = ~done
        new_ubak = where(worse | ~upd, ubak, bu)
        new_vbak = where(worse | ~upd, vbak, bv)
        new_sb = where(upd, where(worse, sb_worse, step), step_back)
        new_bu = where(upd, where(worse, ubak + sb_worse * dxn, bu + step * dxn), bu)
        new_bv = where(upd, where(worse, vbak + sb_worse * dyn, bv + step * dyn), bv)
        bE = where(upd & ~worse, energy, bE)
        done = done | (new_sb.abs() < cfg.trace_gn_threshold)
        bu, bv, ubak, vbak, step_back = new_bu, new_bv, new_ubak, new_vbak, new_sb
    best_u, best_v, best_energy = bu, bv, bE

    outlier = ~(best_energy < energy_th * cfg.trace_extra_slack_on_th)
    horiz = dxn * dxn > dyn * dyn

    def interval(coord_lo, coord_hi, axis):
        prc = pr[:, 0] if axis else pr[:, 1]
        ktc = Kt[:, 0] if axis else Kt[:, 1]
        lo = (pr[:, 2] * coord_lo - prc) / (ktc - Kt[:, 2] * coord_lo)
        hi = (pr[:, 2] * coord_hi - prc) / (ktc - Kt[:, 2] * coord_hi)
        return lo, hi

    lo_h, hi_h = interval(best_u - error_in_pixel * dxn, best_u + error_in_pixel * dxn, True)
    lo_v, hi_v = interval(best_v - error_in_pixel * dyn, best_v + error_in_pixel * dyn, False)
    id_lo = where(horiz, lo_h, lo_v)
    id_hi = where(horiz, hi_h, hi_v)
    id_min_new = torch.minimum(id_lo, id_hi)
    id_max_new = torch.maximum(id_lo, id_hi)
    bad_interval = ~torch.isfinite(id_min_new) | ~torch.isfinite(id_max_new) | (id_max_new < 0)

    def full(x):
        return torch.full((P,), x, dtype=torch.int32, device=dev)

    was_outlier = state.status == IPS_OUTLIER
    new_status = full(IPS_GOOD)
    new_status = where(outlier | bad_interval,
                       where(was_outlier, full(IPS_OOB), full(IPS_OUTLIER)), new_status)
    new_status = where(badcond, full(IPS_BADCONDITION), new_status)
    new_status = where(skipped, full(IPS_SKIPPED), new_status)
    new_status = where(oob, full(IPS_OOB), new_status)
    new_status = where(skip, state.status, new_status)

    good = (new_status == IPS_GOOD) & ~skip
    sb = skipped | badcond
    m1 = torch.full_like(u, -1.0)
    last_u = where(good, best_u, where(sb, 0.5 * (u_min + u_max), m1))
    last_v = where(good, best_v, where(sb, 0.5 * (v_min + v_max), m1))
    interval_out = where(good, 2.0 * error_in_pixel, where(sb, dist, torch.zeros_like(u)))
    return TraceState(
        idepth_min=where(good, id_min_new, state.idepth_min),
        idepth_max=where(good, id_max_new, state.idepth_max),
        status=new_status,
        quality=where(skip | ~good, state.quality, quality),
        last_u=where(skip, state.last_u, last_u),
        last_v=where(skip, state.last_v, last_v),
        last_interval=where(skip, state.last_interval, interval_out),
    )
