"""Direct photometric refinement of the two-view bootstrap (port of
hslam_tpu/ops/init_refine.py, DirectRefinement).

After the two-view reconstruction, a level-0 photometric LM refines the
relative pose, the relative affine brightness and the per-feature inverse
depths, with the reference's three regularizers: the translation/alpha
prior until the solution "snaps", the iR coupling after it, and 0.1x Huber
weight for untriangulated features.

The JAX `lax.while_loop` becomes a Python loop with the same stopping rule
(at most `max_iterations`, and stop once `done`); the `done` test reads a
device scalar, one host sync per iteration. Accept/reject stays branchless
(`torch.where` on the accept flag), so the state after the loop is the
JAX loop's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import PATTERN, PATTERN_NUM, Config
from ..utils import lie
from ..utils.interp import bilinear


class RefineResult(NamedTuple):
    R: torch.Tensor          # (3, 3) firstToNew rotation
    t: torch.Tensor          # (3,)
    aff: torch.Tensor        # (2,) relative (a, b)
    idepth: torch.Tensor     # (P,) refined inverse depths (first frame)
    good: torch.Tensor       # (P,) bool
    snapped: torch.Tensor    # () bool, alpha prior released
    energy: torch.Tensor     # () mean photometric energy per good point


def _residual_pass(colors, u, v, idepth, good, tri, R, t, aff, target, K4,
                   cfg: Config):
    """One evaluation at (R, t, aff, idepth): per-point energies, the 8x8
    pose+affine system and the per-point Schur scalars (calcResAndGS)."""
    H_img, W_img = target.shape[0], target.shape[1]
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=u.device)
    up = u[:, None] + pat[None, :, 0]
    vp = v[:, None] + pat[None, :, 1]
    xh = (up - cx) / fx
    yh = (vp - cy) / fy
    ptx = R[0, 0] * xh + R[0, 1] * yh + R[0, 2] + t[0] * idepth[:, None]
    pty = R[1, 0] * xh + R[1, 1] * yh + R[1, 2] + t[1] * idepth[:, None]
    ptz = R[2, 0] * xh + R[2, 1] * yh + R[2, 2] + t[2] * idepth[:, None]
    ptzs = torch.where(ptz.abs() < 1e-12, torch.full_like(ptz, 1e-12), ptz)
    un = ptx / ptzs
    vn = pty / ptzs
    Ku = fx * un + cx
    Kv = fy * vn + cy
    new_idepth = idepth[:, None] / ptzs
    inb = (Ku > 1) & (Kv > 1) & (Ku < W_img - 2) & (Kv < H_img - 2) & (new_idepth > 0)

    hit = bilinear(target, Ku, Kv)                         # (P, 8, 3)
    hit_I, hit_dx, hit_dy = hit[..., 0], hit[..., 1], hit[..., 2]
    a_rel = torch.exp(aff[0])
    residual = hit_I - a_rel * colors - aff[1]
    abs_r = residual.abs()
    hw = torch.where(abs_r < cfg.huber_th, torch.ones_like(abs_r),
                     cfg.huber_th / torch.clamp(abs_r, min=1e-12))
    hw = torch.where(tri[:, None], hw, hw * 0.1)           # untriangulated: 0.1x

    tap_ok = inb & torch.isfinite(hit_I) & torch.isfinite(colors)
    energy_tap = hw * residual * residual * (2.0 - hw)
    energy = torch.where(tap_ok, energy_tap, torch.zeros_like(energy_tap)).sum(-1)
    all_ok = tap_ok.all(-1)
    is_good_new = good & all_ok & (energy <= PATTERN_NUM * cfg.outlier_th * 20.0)

    hws = torch.where(hw < 1.0, torch.sqrt(hw), hw)
    dxdd = (t[0] - t[2] * un) / ptzs
    dydd = (t[1] - t[2] * vn) / ptzs
    dxi = hws * hit_dx * fx
    dyi = hws * hit_dy * fy
    dd = dxdd * dxi + dydd * dyi                           # (P, 8) d r / d idepth
    J = torch.stack([
        new_idepth * dxi,
        new_idepth * dyi,
        -new_idepth * (un * dxi + vn * dyi),
        -un * vn * dxi - (1.0 + vn * vn) * dyi,
        (1.0 + un * un) * dxi + un * vn * dyi,
        un * dyi - vn * dxi,
        hws * (-a_rel) * colors,
        hws * (-torch.ones_like(colors)),
    ], dim=-1)                                             # (P, 8 taps, 8 dof)
    r_w = hws * residual
    m = (is_good_new[:, None] & tap_ok).float()
    Jm = J * m[..., None]
    Jb = torch.einsum("ptk,pt->pk", Jm, dd)
    Hdd = (dd * dd * m).sum(-1)
    bd = (dd * r_w * m).sum(-1)
    H8 = torch.einsum("pti,ptj->ij", Jm, Jm)
    b8 = torch.einsum("pti,pt->i", Jm, r_w * m)
    step_den = torch.sqrt((dxdd * fx) ** 2 + (dydd * fy) ** 2)
    maxstep = torch.where(tap_ok, 1.0 / torch.clamp(step_den, min=1e-10),
                          torch.full_like(step_den, 1e10)).amin(-1)
    return energy, is_good_new, Jb, Hdd, bd, H8, b8, maxstep


def direct_refine(first_dir0, second_dir0, u, v, valid, idepth0, triangulated,
                  R0, t0, K4, cfg: Config, max_iterations: int = 60,
                  aff0: Optional[torch.Tensor] = None) -> RefineResult:
    """DirectRefinement::Refine at level 0. first_dir0/second_dir0 are the
    (H, W, 3) [I, dx, dy] level-0 images; R0, t0 firstToNew."""
    dev = u.device
    pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=dev)
    colors = bilinear(first_dir0[..., 0], u[:, None] + pat[None, :, 0],
                      v[:, None] + pat[None, :, 1])
    finite = torch.isfinite(colors).all(-1) & valid
    idepth = torch.where(triangulated, torch.clamp(idepth0, min=1e-3),
                         torch.ones_like(idepth0))
    iR = idepth
    aff = torch.zeros(2, device=dev) if aff0 is None else aff0
    alphaK = 2.5 * 2.5
    alphaW = 150.0 * 150.0
    coupling = 1.0
    npts = torch.clamp(finite.float().sum(), min=1.0)
    zero = torch.zeros((), device=dev)

    def masked_sum(x, m):
        return torch.where(m, x, torch.zeros_like(x)).sum()

    def total_energy(energy, is_good, idepth_c, iR_c, t_c, snapped):
        E_photo = masked_sum(energy, is_good)
        alphaE = alphaW * (masked_sum((idepth_c - 1.0) ** 2, is_good) + (t_c * t_c).sum() * npts)
        capped = alphaE > alphaK * npts
        alphaE = torch.clamp(alphaE, max=float(alphaK) * npts)
        E_coup = torch.where(snapped, coupling * masked_sum((idepth_c - iR_c) ** 2, is_good), zero)
        return E_photo + alphaE + E_coup, capped

    def solve_step(Jb, Hdd, bd, H8, b8, idepth_c, iR_c, t_c, is_good, lam):
        e_alpha = masked_sum((idepth_c - 1.0) ** 2, is_good)
        alphaE = alphaW * (e_alpha + (t_c * t_c).sum() * npts)
        alpha_opt = torch.where(alphaE > alphaK * npts, zero, zero + alphaW)
        coupled = alpha_opt == 0.0
        bd_r = bd + alpha_opt * (idepth_c - 1.0)
        Hdd_r = Hdd + alpha_opt
        bd_r = bd_r + torch.where(coupled, coupling * (idepth_c - iR_c), torch.zeros_like(bd_r))
        Hdd_r = Hdd_r + torch.where(coupled, zero + coupling, zero)
        w = torch.where(is_good, 1.0 / (1.0 + Hdd_r), torch.zeros_like(Hdd_r))
        Hsc = torch.einsum("pi,pj,p->ij", Jb, Jb, w)
        bsc = torch.einsum("pi,p,p->i", Jb, bd_r, w)
        Hl = H8 + torch.diag(torch.cat([alpha_opt * npts * torch.ones(3, device=dev),
                                        torch.zeros(5, device=dev)]))
        bl = b8 + torch.cat([alpha_opt * npts * t_c, torch.zeros(5, device=dev)])
        Hl = Hl + torch.diag(torch.diagonal(Hl)) * lam
        Hl = Hl - Hsc * (1.0 / (1.0 + lam))
        bl2 = bl - bsc * (1.0 / (1.0 + lam))
        inc, _ = torch.linalg.solve_ex(Hl, bl2[:, None])
        inc = -inc[:, 0]
        inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))
        return inc, w, bd_r

    energy_c, good_c, Jb, Hdd, bd, H8, b8, maxstep = _residual_pass(
        colors, u, v, idepth, finite, triangulated, R0, t0, aff, second_dir0, K4, cfg)
    R, t, aff_c, idepth_c, iR_c = R0, t0, aff, idepth, iR
    lam = torch.tensor(0.1, device=dev)
    fails = torch.zeros((), dtype=torch.int32, device=dev)
    snapped = torch.zeros((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        inc, w, bd_r = solve_step(Jb, Hdd, bd, H8, b8, idepth_c, iR_c, t, good_c, lam)
        dR, dt = lie.se3_exp(inc[:6])
        R_n, t_n = lie.se3_mul(dR, dt, R, t)
        aff_n = aff_c + inc[6:8]
        # per-point idepth step with the maxstep clamp (doStep)
        b_pt = bd_r + Jb @ inc
        step = -b_pt * w / (1.0 + lam)
        ms = 0.25 * maxstep
        step = torch.maximum(torch.minimum(step, ms), -ms)
        idepth_n = torch.clamp(idepth_c + step, 1e-3, 50.0)
        idepth_n = torch.where(good_c, idepth_n, iR_c)
        (energy_n, good_n, Jb_n, Hdd_n, bd_n, H8_n, b8_n, maxstep_n) = _residual_pass(
            colors, u, v, idepth_n, finite, triangulated, R_n, t_n, aff_n,
            second_dir0, K4, cfg)
        E_old, _ = total_energy(energy_c, good_c, idepth_c, iR_c, t, snapped)
        E_new, capped_n = total_energy(energy_n, good_n, idepth_n, iR_c, t_n, snapped)
        accept = (E_new < E_old) & ~done
        snapped = snapped | (accept & capped_n)
        R = torch.where(accept, R_n, R)
        t = torch.where(accept, t_n, t)
        aff_c = torch.where(accept, aff_n, aff_c)
        idepth_c = torch.where(accept, idepth_n, idepth_c)
        good_c = torch.where(accept, good_n, good_c)
        energy_c = torch.where(accept, energy_n, energy_c)
        Jb = torch.where(accept, Jb_n, Jb)
        Hdd = torch.where(accept, Hdd_n, Hdd)
        bd = torch.where(accept, bd_n, bd)
        H8 = torch.where(accept, H8_n, H8)
        b8 = torch.where(accept, b8_n, b8)
        maxstep = torch.where(accept, maxstep_n, maxstep)
        iR_c = torch.where(accept & good_c, idepth_c, iR_c)     # optReg
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-4),
                          torch.clamp(lam * 4.0, max=1e4))
        fails = torch.where(accept, torch.zeros_like(fails), fails + 1)
        done = done | (torch.linalg.norm(inc) <= 1e-4) | (fails >= 2)
        if bool(done):                                           # host sync
            break
    n_good = torch.clamp(good_c.sum(), min=1)
    return RefineResult(R=R, t=t, aff=aff_c, idepth=idepth_c, good=good_c,
                        snapped=snapped, energy=masked_sum(energy_c, good_c) / n_good)
