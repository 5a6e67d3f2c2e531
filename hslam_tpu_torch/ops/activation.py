"""Batched candidate-point activation: idepth-only LM against the window
(port of hslam_tpu/ops/activation.py, System::optimizeImmaturePoint).

All candidates run `gn_its_on_point_activation` LM steps at once (a
fixed-count Python loop, no host sync). Taps are sampled directly from the
window images with the JAX package's 12x12 gather-window rule applied as an
OOB mask (see ops/ba.py), which is the path its activation takes by
default. The (P, F) per-host gathers index the relative poses with clamped
host slots (C5).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PATTERN, PATTERN_NUM, Config
from ..models import window as W
from ..models.calib import Calib
from ..utils import lie
from .ba import sample_taps, window_in_mask


class ActivationResult(NamedTuple):
    idepth: torch.Tensor     # (P,)
    ok: torch.Tensor         # (P,) bool
    res_in: torch.Tensor     # (P, F) bool


def _linearize_idepth(u, v, idepth, color, weights, host, R_rel, t_rel,
                      a_rel, b_rel, images, energy_th, slack, intr, cfg: Config,
                      window_gate: bool = True):
    """(energy (P, F), Hdd (P,), bd (P,), state_in (P, F), oob (P, F))."""
    F = images.shape[0]
    Hh, Ww = images.shape[1], images.shape[2]
    h = torch.clamp(host.long(), 0, F - 1)
    Rr, tr = R_rel[h], t_rel[h]
    a_pf, b_pf = a_rel[h], b_rel[h]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]

    pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=u.device)
    up = u[:, None] + pat[None, :, 0]
    vp = v[:, None] + pat[None, :, 1]
    dirs = torch.stack([(up - cx) / fx, (vp - cy) / fy, torch.ones_like(up)], -1)
    rot = torch.einsum("pfij,pkj->pfki", Rr, dirs)
    ptp = rot + tr[:, :, None, :] * idepth[:, None, None, None]
    zz = ptp[..., 2]
    drescale = 1.0 / torch.where(zz.abs() < 1e-12, torch.full_like(zz, 1e-12), zz)
    un = ptp[..., 0] * drescale
    vn = ptp[..., 1] * drescale
    Ku = un * fx + cx
    Kv = vn * fy + cy
    ok_proj = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < Ww - 3) & (Kv < Hh - 3)
    oob = ~ok_proj.all(-1)
    if window_gate:
        oob = oob | ~window_in_mask(Ku, Kv, Hh, Ww)
    hit = sample_taps(images, Ku, Kv)

    residual = hit[..., 0] - (a_pf[..., None] * color[:, None, :] + b_pf[..., None])
    abs_r = residual.abs()
    hw = torch.where(abs_r < cfg.huber_th, torch.ones_like(abs_r),
                     cfg.huber_th / torch.clamp(abs_r, min=1e-12))
    w2 = weights[:, None, :] ** 2
    energy = torch.sum(w2 * hw * residual ** 2 * (2.0 - hw), dim=-1)

    dxi = hit[..., 1] * fx
    dyi = hit[..., 2] * fy
    d_id = (dxi * drescale * (tr[:, :, None, 0] - tr[:, :, None, 2] * un)
            + dyi * drescale * (tr[:, :, None, 1] - tr[:, :, None, 2] * vn))

    cap = energy_th[:, None] * slack
    out = energy > cap
    energy = torch.where(out, cap.expand_as(energy), energy)
    state_in = ~out & ~oob
    hww = hw * w2
    mask = state_in[..., None].float()
    Hdd = torch.sum(hww * d_id * d_id * mask, dim=(1, 2))
    bd = torch.sum(hww * residual * d_id * mask, dim=(1, 2))
    energy = torch.where(oob, torch.zeros_like(energy), energy)
    return energy, Hdd, bd, state_in, oob


def activate_points(frames: W.Frames, calib: Calib, u, v, idepth0, color,
                    weights, host, cand_valid, cfg: Config,
                    min_obs: int = 1) -> ActivationResult:
    F = frames.valid.shape[0]
    dev = u.device
    intr = calib.value
    R_cur, t_cur = W.frame_poses(frames)
    Ri, ti = lie.se3_inverse(R_cur, t_cur)
    R_rel = R_cur[None] @ Ri[:, None]
    t_rel = torch.einsum("tij,hj->hti", R_cur, ti) + t_cur[None]
    aff = W.frame_affine(frames)
    exp_ = torch.where(frames.exposure == 0, torch.ones_like(frames.exposure),
                       frames.exposure)
    a_rel = torch.exp(aff[None, :, 0] - aff[:, None, 0]) * (exp_[None, :] / exp_[:, None])
    b_rel = aff[None, :, 1] - a_rel * aff[:, None, 1]
    grid = (cand_valid[:, None] & frames.valid[None, :]
            & (host.long()[:, None] != torch.arange(F, device=dev)[None, :]))
    energy_th = torch.full_like(u, PATTERN_NUM * cfg.outlier_th
                                * cfg.overall_energy_th_weight ** 2)

    def lin(idep, slack):
        e, Hdd, bd, s_in, _ = _linearize_idepth(
            u, v, idep, color, weights, host, R_rel, t_rel, a_rel, b_rel,
            frames.images, energy_th, slack, intr, cfg)
        return torch.where(grid, e, torch.zeros_like(e)).sum(-1), Hdd, bd, s_in & grid

    E, Hdd, bd, s_in = lin(idepth0, 1000.0)
    ok = torch.isfinite(E) & (Hdd >= cfg.min_idepth_h_act)
    idep = idepth0
    lam = torch.full_like(u, 0.1)
    for _ in range(cfg.gn_its_on_point_activation):
        new_id = idep - bd / (Hdd * (1.0 + lam) + 1e-12)
        E_n, Hdd_n, bd_n, in_n = lin(new_id, 1.0)
        still_ok = torch.isfinite(E) & (Hdd_n >= cfg.min_idepth_h_act)
        accept = (E_n < E) & ok
        idep = torch.where(accept, new_id, idep)
        E = torch.where(accept, E_n, E)
        Hdd = torch.where(accept, Hdd_n, Hdd)
        bd = torch.where(accept, bd_n, bd)
        s_in = torch.where(accept[:, None], in_n, s_in)
        lam = torch.where(accept, lam * 0.5, lam * 5.0)
        ok = ok & still_ok
    n_good = s_in.sum(-1)
    ok = ok & torch.isfinite(idep) & (n_good >= min_obs) & cand_valid
    return ActivationResult(idepth=idep, ok=ok, res_in=s_in)
