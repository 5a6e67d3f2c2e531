"""Windowed photometric bundle adjustment — residual linearization, Hessian
assembly, Schur complement, nullspaces (port of hslam_tpu/ops/ba.py).

Same factored design as the JAX module: each (point, target) residual has
per-pattern coefficients C = [JIdx | JabF] and a 4-row relative basis
[pixel-x, pixel-y, a_rel, b_rel]; pair blocks are grouped by host slot and
stitched into the absolute (D, D) system, D = 4 + 8 F, through the
adjoints. Everything stays in the reference's solver units.

Target intensities: the JAX optimizer gathers one 12x12 window per
(point, frame) (`build_window_table` / `_window_taps`) and marks a residual
OOB when a pattern tap leaves that window. The port samples the taps
directly (bilinear on the stored [I, dx, dy] images, the JAX package's
packed-cell path) and applies the same window rule as a mask
(`window_gate=True`), which is what ba_optimize and marginalize_points use.
For an in-window tap both give the same samples: the window's central
differences are the stored gradients there. The gather indices come from
clamped coordinates, so no index is ever out of range (C5).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CALIB_SCALE, CPARS, FRAME_STATE_SCALE, PATTERN, SCALE_C, SCALE_F, Config
from ..models import window as W
from ..models.calib import Calib
from ..utils import lie

WIN = 12          # gather-window side of the JAX optimizer path
WIN_STRIDE = 2


def _t(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def compute_adjoints(frames: W.Frames):
    """(AH, AT): (F, F, 8, 8) host/target adjoints, rows scaled by the
    solver preconditioner (EnergyFunctional.cpp:22-82)."""
    F = frames.valid.shape[0]
    R0, t0 = frames.evalpt_R, frames.evalpt_t
    dev = R0.device
    Rh_inv, th_inv = lie.se3_inverse(R0, t0)
    R_ht = R0[None, :, :, :] @ Rh_inv[:, None, :, :]
    t_ht = torch.einsum("tij,hj->hti", R0, th_inv) + t0[None, :, :]
    Adj = lie.se3_adjoint(R_ht, t_ht)                  # (F, F, 6, 6)

    aff0 = (frames.state_zero * _t(FRAME_STATE_SCALE, R0))[:, 6:8]
    exp_ = torch.where(frames.exposure == 0, torch.ones_like(frames.exposure),
                       frames.exposure)
    a_rel = torch.exp(aff0[None, :, 0] - aff0[:, None, 0]) * (exp_[None, :] / exp_[:, None])

    AH = torch.zeros((F, F, 8, 8), dtype=torch.float32, device=dev)
    AT = torch.zeros((F, F, 8, 8), dtype=torch.float32, device=dev)
    AH[:, :, :6, :6] = -Adj.transpose(-1, -2)
    AT[:, :, :6, :6] = torch.eye(6, device=dev)
    AH[:, :, 6, 6] = a_rel
    AH[:, :, 7, 7] = a_rel
    AT[:, :, 6, 6] = -a_rel
    AT[:, :, 7, 7] = -1.0
    row_scale = _t(FRAME_STATE_SCALE, R0)[:, None]
    return AH * row_scale, AT * row_scale


class Linearization(NamedTuple):
    Jpdc: torch.Tensor       # (P, F, 2, 4)
    Jpdxi: torch.Tensor      # (P, F, 2, 6)
    Jpdd: torch.Tensor       # (P, F, 2)
    JIdx: torch.Tensor       # (P, F, 8, 2)
    JabF: torch.Tensor       # (P, F, 8, 2)
    resF: torch.Tensor       # (P, F, 8)
    energy: torch.Tensor     # (P, F)
    energy_raw: torch.Tensor  # (P, F), -1 if OOB
    new_state: torch.Tensor  # (P, F) int32
    center_u: torch.Tensor
    center_v: torch.Tensor
    center_idepth: torch.Tensor
    rel_bs: torch.Tensor
    win_miss: torch.Tensor   # (P, F) bool: OOB only through the window rule
    ind_res: torch.Tensor    # (P, F, 2)
    ind_wgt: torch.Tensor
    ind_ok: torch.Tensor
    ind_energy: torch.Tensor


def sample_taps(images: torch.Tensor, Ku: torch.Tensor, Kv: torch.Tensor):
    """Bilinear [I, dx, dy] of frame f at taps Ku[..., f, :], Kv[..., f, :].

    images (F, H, W, 3); Ku, Kv (P, F, K). Returns (P, F, K, 3). Same
    clamping and lerp order as the JAX packed-cell gather."""
    Fn, Hh, Ww = images.shape[0], images.shape[1], images.shape[2]
    Kuc = torch.clamp(Ku, 0.0, Ww - 1.001)
    Kvc = torch.clamp(Kv, 0.0, Hh - 1.001)
    ix = torch.clamp(torch.floor(Kuc).long(), 0, Ww - 2)
    iy = torch.clamp(torch.floor(Kvc).long(), 0, Hh - 2)
    wx = (Kuc - ix.float())[..., None]
    wy = (Kvc - iy.float())[..., None]
    f_off = (torch.arange(Fn, device=images.device) * (Hh * Ww))[:, None]
    base = f_off + iy * Ww + ix
    flat = images.reshape(Fn * Hh * Ww, 3)
    top = flat[base] * (1 - wx) + flat[base + 1] * wx
    bot = flat[base + Ww] * (1 - wx) + flat[base + Ww + 1] * wx
    return top * (1 - wy) + bot * wy


def window_in_mask(Ku: torch.Tensor, Kv: torch.Tensor, Hh: int, Ww: int):
    """(P, F) bool: all 8 taps inside the 12x12 gather window the JAX
    optimizer anchors at the taps' bounding-box center (ba.py:191-206)."""
    def axis_ok(K, size):
        bb = 0.5 * (K.amax(-1) + K.amin(-1))
        g = torch.floor(bb).long()
        o = torch.clamp(2 * torch.div(g - 5, 2, rounding_mode="floor"), 0, size - WIN)
        i = torch.floor(K - o[..., None].float()).long()
        return ((i >= 1) & (i <= WIN - 3)).all(-1)

    return axis_ok(Ku, Ww) & axis_ok(Kv, Hh)


def linearize(frames: W.Frames, points: W.Points, calib: Calib, cfg: Config,
              window_gate: bool = False) -> Linearization:
    """Relinearize every (point, target-frame) residual at the current
    state with FEJ geometric Jacobians (PointFrameResidual::linearize)."""
    F = frames.valid.shape[0]
    Hh, Ww = frames.images.shape[1], frames.images.shape[2]
    dev = frames.state.device
    fx, fy, cx, cy = calib.value[0], calib.value[1], calib.value[2], calib.value[3]

    R_cur, t_cur = W.frame_poses(frames)
    R0, t0 = frames.evalpt_R, frames.evalpt_t
    aff = W.frame_affine(frames)
    aff0 = W.frame_affine_zero(frames)
    exp_ = torch.where(frames.exposure == 0, torch.ones_like(frames.exposure),
                       frames.exposure)

    def rel(Ra, ta, Rb, tb):
        Ri, ti = lie.se3_inverse(Ra, ta)
        return Rb[None] @ Ri[:, None], torch.einsum("tij,hj->hti", Rb, ti) + tb[None]

    PRE_R0, PRE_t0 = rel(R0, t0, R0, t0)
    PRE_R, PRE_t = rel(R_cur, t_cur, R_cur, t_cur)
    a_rel = torch.exp(aff[None, :, 0] - aff[:, None, 0]) * (exp_[None, :] / exp_[:, None])
    b_rel = aff[None, :, 1] - a_rel * aff[:, None, 1]
    b0_host = aff0[:, 1]

    h_idx = torch.clamp(points.host.long(), 0, F - 1)
    Rr0, tr0 = PRE_R0[h_idx], PRE_t0[h_idx]          # (P, F, 3, 3), (P, F, 3)
    Rr, tr = PRE_R[h_idx], PRE_t[h_idx]
    a_pf, b_pf = a_rel[h_idx], b_rel[h_idx]
    b0_p = b0_host[h_idx]

    # FEJ center projection (OptimizationClasses.cpp:70-122)
    KliP = torch.stack([(points.u - cx) / fx, (points.v - cy) / fy,
                        torch.ones_like(points.u)], dim=-1)          # (P, 3)
    ptp0 = (Rr0 @ KliP[:, None, :, None])[..., 0] + tr0 * points.idepth_zero[:, None, None]
    z0 = ptp0[..., 2]
    drescale = 1.0 / torch.where(z0.abs() < 1e-12, torch.full_like(z0, 1e-12), z0)
    new_idepth0 = points.idepth_zero[:, None] * drescale
    u_n = ptp0[..., 0] * drescale
    v_n = ptp0[..., 1] * drescale
    Ku0 = u_n * fx + cx
    Kv0 = v_n * fy + cy
    fej_ok = (drescale > 0) & (Ku0 > 1.1) & (Kv0 > 1.1) & (Ku0 < Ww - 3) & (Kv0 < Hh - 3)

    d_d_x = drescale * (tr0[..., 0] - tr0[..., 2] * u_n) * fx
    d_d_y = drescale * (tr0[..., 1] - tr0[..., 2] * v_n) * fy
    Jpdd = torch.stack([d_d_x, d_d_y], dim=-1)

    R00, R01 = Rr0[..., 0, 0], Rr0[..., 0, 1]
    R10, R11 = Rr0[..., 1, 0], Rr0[..., 1, 1]
    R20, R21 = Rr0[..., 2, 0], Rr0[..., 2, 1]
    dCx2 = drescale * (R20 * u_n - R00)
    dCx3 = fx * drescale * (R21 * u_n - R01) / fy
    dCx0 = KliP[:, None, 0] * dCx2
    dCx1 = KliP[:, None, 1] * dCx3
    dCy2 = fy * drescale * (R20 * v_n - R10) / fx
    dCy3 = drescale * (R21 * v_n - R11)
    dCy0 = KliP[:, None, 0] * dCy2
    dCy1 = KliP[:, None, 1] * dCy3
    Jpdc = torch.stack([
        torch.stack([(dCx0 + u_n) * SCALE_F, dCx1 * SCALE_F,
                     (dCx2 + 1.0) * SCALE_C, dCx3 * SCALE_C], dim=-1),
        torch.stack([dCy0 * SCALE_F, (dCy1 + v_n) * SCALE_F,
                     dCy2 * SCALE_C, (dCy3 + 1.0) * SCALE_C], dim=-1),
    ], dim=-2)

    zero = torch.zeros_like(u_n)
    Jpdxi = torch.stack([
        torch.stack([new_idepth0 * fx, zero, -new_idepth0 * u_n * fx,
                     -u_n * v_n * fx, (1.0 + u_n * u_n) * fx, -v_n * fx], dim=-1),
        torch.stack([zero, new_idepth0 * fy, -new_idepth0 * v_n * fy,
                     -(1.0 + v_n * v_n) * fy, u_n * v_n * fy, u_n * fy], dim=-1),
    ], dim=-2)

    # current-state pattern projection + residuals
    pat = _t(PATTERN, points.u)
    up = points.u[:, None] + pat[None, :, 0]
    vp = points.v[:, None] + pat[None, :, 1]
    dirs = torch.stack([(up - cx) / fx, (vp - cy) / fy, torch.ones_like(up)], dim=-1)
    rot = torch.einsum("pfij,pkj->pfki", Rr, dirs)                   # (P, F, 8, 3)
    ptp = rot + tr[:, :, None, :] * points.idepth[:, None, None, None]
    zz = ptp[..., 2]
    z = torch.where(zz.abs() < 1e-12, torch.full_like(zz, 1e-12), zz)
    Ku = fx * ptp[..., 0] / z + cx
    Kv = fy * ptp[..., 1] / z + cy
    proj_ok = (Ku > 1.1) & (Kv > 1.1) & (Ku < Ww - 3) & (Kv < Hh - 3)

    center_u = Ku[..., 4]
    center_v = Kv[..., 4]
    center_idepth = points.idepth[:, None] / z[..., 4]

    rot_c = rot[..., 4, :]
    zc = rot_c[..., 2]
    z_inf = torch.where(zc.abs() < 1e-12, torch.full_like(zc, 1e-12), zc)
    u_inf = fx * rot_c[..., 0] / z_inf + cx
    v_inf = fy * rot_c[..., 1] / z_inf + cy
    rel_bs = 0.01 * torch.sqrt((u_inf - center_u) ** 2 + (v_inf - center_v) ** 2)

    hit = sample_taps(frames.images, Ku, Kv)
    hit_I, hit_dx, hit_dy = hit[..., 0], hit[..., 1], hit[..., 2]

    residual = hit_I - (a_pf[..., None] * points.color[:, None, :] + b_pf[..., None])
    drdA = points.color[:, None, :] - b0_p[:, None, None]

    c_w = cfg.outlier_th_sum_component
    w_grad = torch.sqrt(c_w / (c_w + hit_dx ** 2 + hit_dy ** 2))
    w = 0.5 * (w_grad + points.weight[:, None, :])

    abs_r = residual.abs()
    hw = torch.where(abs_r < cfg.huber_th, torch.ones_like(abs_r),
                     cfg.huber_th / torch.clamp(abs_r, min=1e-12))
    energy_terms = w * w * hw * residual * residual * (2.0 - hw)
    hw_j = torch.where(hw < 1.0, torch.sqrt(hw), hw) * w

    JIdx = torch.stack([hit_dx * hw_j, hit_dy * hw_j], dim=-1)
    JabF = torch.stack([drdA * hw_j, hw_j], dim=-1)
    resF = residual * hw_j
    wJI2 = torch.sum((hw_j * hit_dx) ** 2 + (hw_j * hit_dy) ** 2, dim=-1)

    oob = ~fej_ok | ~proj_ok.all(-1) | ~torch.isfinite(hit_I).all(-1)
    if window_gate:
        win_ok = window_in_mask(Ku, Kv, Hh, Ww)
        win_miss = ~oob & ~win_ok
        oob = oob | ~win_ok
    else:
        win_miss = torch.zeros_like(oob)
    energy_raw = energy_terms.sum(-1)
    th = torch.maximum(frames.energy_th[h_idx][:, None], frames.energy_th[None, :])
    out = (energy_raw > th) | (wJI2 < 2.0)
    energy = torch.where(out, th, energy_raw)
    new_state = torch.where(oob, W.RES_OOB,
                            torch.where(out, W.RES_OUT, W.RES_IN)).to(torch.int32)
    energy_raw = torch.where(oob, torch.full_like(energy_raw, -1.0), energy_raw)

    # indirect reprojection factors (hybrid layer; ind_valid is all-False
    # in the direct-only slice, kept so the structure matches)
    center_ok = ((z[..., 4] > 0) & fej_ok & (center_u > 1.1) & (center_v > 1.1)
                 & (center_u < Ww - 3) & (center_v < Hh - 3))
    ind_rx = center_u - points.ind_u
    ind_ry = center_v - points.ind_v
    ind_e2 = ind_rx * ind_rx + ind_ry * ind_ry
    ind_r = torch.sqrt(torch.clamp(ind_e2, min=1e-20))
    ihw = torch.where(ind_r < cfg.indirect_huber_px, torch.ones_like(ind_r),
                      cfg.indirect_huber_px / ind_r)
    ind_ok = points.ind_valid & center_ok & (ind_r < cfg.indirect_gate_px)
    return Linearization(
        Jpdc=Jpdc, Jpdxi=Jpdxi, Jpdd=Jpdd, JIdx=JIdx, JabF=JabF, resF=resF,
        energy=energy, energy_raw=energy_raw, new_state=new_state,
        center_u=center_u, center_v=center_v, center_idepth=center_idepth,
        rel_bs=rel_bs, win_miss=win_miss,
        ind_res=torch.stack([ind_rx, ind_ry], dim=-1),
        ind_wgt=points.ind_w * ihw, ind_ok=ind_ok,
        ind_energy=points.ind_w * ihw * ind_e2 * (2.0 - ihw),
    )


class GNSystem(NamedTuple):
    H: torch.Tensor        # (D, D)
    b: torch.Tensor        # (D,)
    Hdd: torch.Tensor      # (P,)
    bd: torch.Tensor       # (P,)
    g: torch.Tensor        # (P, D)
    num_res: torch.Tensor  # ()


def accumulate(lin: Linearization, active: torch.Tensor, host: torch.Tensor,
               AH: torch.Tensor, AT: torch.Tensor, n_frames: int,
               ind_active: Optional[torch.Tensor] = None) -> GNSystem:
    """Assemble the absolute GN system from the factored Jacobians: pair
    blocks in the relative 12-dim basis, grouped by host, then the adjoint
    stitch into (D, D) (stitchDoubleInternal)."""
    P, F = active.shape
    D = CPARS + 8 * F
    dev = active.device
    m = active.float()

    C = torch.cat([lin.JIdx, lin.JabF], dim=-1)                       # (P, F, 8, 4)
    M = C.transpose(-1, -2) @ C                                       # (P, F, 4, 4)
    mvec = (C.transpose(-1, -2) @ lin.resF[..., None])[..., 0]        # (P, F, 4)

    B = torch.zeros((P, F, 4, 12), dtype=torch.float32, device=dev)
    B[:, :, 0:2, 0:4] = lin.Jpdc
    B[:, :, 0:2, 4:10] = lin.Jpdxi
    B[:, :, 2, 10] = 1.0
    B[:, :, 3, 11] = 1.0

    Mw = M * m[..., None, None]
    mw = mvec * m[..., None]
    if ind_active is not None:
        iw = lin.ind_wgt * ind_active.float()
        Mw = Mw.clone()
        mw = mw.clone()
        Mw[..., 0, 0] += iw
        Mw[..., 1, 1] += iw
        mw[..., 0] += iw * lin.ind_res[..., 0]
        mw[..., 1] += iw * lin.ind_res[..., 1]

    Bt = B.transpose(-1, -2)                                          # (P, F, 12, 4)
    G = Bt @ (Mw @ B)                                                 # (P, F, 12, 12)
    h = torch.clamp(host.long(), 0, F - 1)
    onehot = torch.nn.functional.one_hot(h, F).float()                # (P, F)
    Hrel = torch.einsum("ph,pfij->hfij", onehot, G)                   # (F, F, 12, 12)
    brel = torch.einsum("ph,pfj->hfj", onehot, (Bt @ mw[..., None])[..., 0])

    Hcc = Hrel[:, :, 0:4, 0:4].sum((0, 1))
    Hcr = Hrel[:, :, 0:4, 4:12]
    Hrr = Hrel[:, :, 4:12, 4:12]
    AHt, ATt = AH.transpose(-1, -2), AT.transpose(-1, -2)
    Hch = Hcr @ AHt
    Hct = Hcr @ ATt
    Hhh = AH @ (Hrr @ AHt)
    Htt = AT @ (Hrr @ ATt)
    Hht = AH @ (Hrr @ ATt)
    Hframes = Hht + Hht.permute(1, 0, 3, 2)
    diag_blocks = Hhh.sum(1) + Htt.sum(0)
    eyeF = torch.eye(F, device=dev)
    Hframes = Hframes + eyeF[:, :, None, None] * diag_blocks[:, None, :, :]
    Hcf = Hch.sum(1) + Hct.sum(0)                                     # (F, 4, 8)

    H = torch.zeros((D, D), dtype=torch.float32, device=dev)
    H[:CPARS, :CPARS] = Hcc
    Hcf_flat = Hcf.transpose(0, 1).reshape(CPARS, 8 * F)
    H[:CPARS, CPARS:] = Hcf_flat
    H[CPARS:, :CPARS] = Hcf_flat.T
    H[CPARS:, CPARS:] = Hframes.transpose(1, 2).reshape(8 * F, 8 * F)

    b_c = brel[:, :, 0:4].sum((0, 1))
    br = brel[:, :, 4:12][..., None]
    b_frames = (AH @ br)[..., 0].sum(1) + (AT @ br)[..., 0].sum(0)
    b = torch.cat([b_c, b_frames.reshape(-1)])

    V_d = torch.cat([lin.Jpdd, torch.zeros((P, F, 2), device=dev)], dim=-1)
    MV = (Mw @ V_d[..., None])[..., 0]
    Hdd = (V_d * MV).sum((1, 2))
    bd = (V_d * mw).sum((1, 2))
    grel = (Bt @ MV[..., None])[..., 0]                               # (P, F, 12)
    g_c = grel[:, :, 0:4].sum(1)
    gr = grel[:, :, 4:12][..., None]
    g_t = (AT[h] @ gr)[..., 0]
    g_h = (AH[h] @ gr)[..., 0].sum(1)
    g_frames = g_t + onehot[:, :, None] * g_h[:, None, :]
    g = torch.cat([g_c, g_frames.reshape(P, 8 * F)], dim=-1)
    return GNSystem(H=H, b=b, Hdd=Hdd, bd=bd, g=g, num_res=m.sum())


def schur_complement(sys: GNSystem, point_prior, point_active):
    Hdd_total = sys.Hdd + point_prior
    HdiF = torch.where(point_active, 1.0 / torch.clamp(Hdd_total, min=1e-10),
                       torch.zeros_like(Hdd_total))
    gw = sys.g * HdiF[:, None]
    return sys.g.T @ gw, gw.T @ sys.bd, HdiF


def resubstitute(sys: GNSystem, HdiF, x):
    return -HdiF * (sys.bd - sys.g @ x)


def nullspaces(frames: W.Frames) -> torch.Tensor:
    """(D, 7): 6 rigid + 1 scale gauge directions in solver units."""
    F = frames.valid.shape[0]
    D = CPARS + 8 * F
    dev = frames.evalpt_R.device
    Adj = lie.se3_adjoint(frames.evalpt_R, frames.evalpt_t)
    inv_scale = 1.0 / _t(FRAME_STATE_SCALE[:6], Adj)
    valid = frames.valid.float()
    ns = torch.zeros((D, 7), dtype=torch.float32, device=dev)
    pad = torch.zeros((F, 2), device=dev)
    for i in range(6):
        col = Adj[:, :, i] * inv_scale[None, :] * valid[:, None]
        ns[CPARS:, i] = torch.cat([col, pad], dim=-1).reshape(-1)
    ns[CPARS:, 6] = torch.cat([frames.evalpt_t * inv_scale[None, :3] * valid[:, None],
                               torch.zeros((F, 5), device=dev)], dim=-1).reshape(-1)
    return ns


def nullspace_projector(N: torch.Tensor, svd_eps: float = 1e-5) -> torch.Tensor:
    norms = torch.linalg.norm(N, dim=0, keepdim=True)
    Nn = N / torch.clamp(norms, min=1e-12)
    U_, S, _ = torch.linalg.svd(Nn, full_matrices=False)
    S_inv = torch.where(S > svd_eps * S.max(), 1.0 / torch.clamp(S, min=1e-20),
                        torch.zeros_like(S))
    proj = U_ @ ((S_inv * S)[:, None] * U_.T)
    return 0.5 * (proj + proj.T)


def orthogonalize(vec, N, svd_eps: float = 1e-5):
    return vec - nullspace_projector(N, svd_eps) @ vec


# --------------------------------------------------------------------------
# mode-1 (frozen-linearization) residuals; see the JAX module for why the
# reference only ever reaches them through marginalization
# --------------------------------------------------------------------------


class FrozenResiduals(NamedTuple):
    Jpdc: torch.Tensor
    Jpdxi: torch.Tensor
    Jpdd: torch.Tensor
    JIdx: torch.Tensor
    JabF: torch.Tensor
    res_toZero: torch.Tensor
    is_linearized: torch.Tensor


def pair_deltas(frames: W.Frames, calib: Calib, AH, AT):
    """(dp (F, F, 8), c_delta (4,)) in solver units (setDeltaF)."""
    f_delta = (frames.state - frames.state_zero) * frames.valid[:, None]
    dp = (torch.einsum("hfij,hi->hfj", AH, f_delta)
          + torch.einsum("hfij,fi->hfj", AT, f_delta))
    c_delta = (calib.value - calib.value_zero) / _t(CALIB_SCALE, calib.value)
    return dp, c_delta


def _jp_delta(lin_or_frozen, dp_pf, c_delta, d_delta):
    jx = ((lin_or_frozen.Jpdxi[:, :, 0] * dp_pf[..., :6]).sum(-1)
          + lin_or_frozen.Jpdc[:, :, 0] @ c_delta
          + lin_or_frozen.Jpdd[..., 0] * d_delta[:, None])
    jy = ((lin_or_frozen.Jpdxi[:, :, 1] * dp_pf[..., :6]).sum(-1)
          + lin_or_frozen.Jpdc[:, :, 1] @ c_delta
          + lin_or_frozen.Jpdd[..., 1] * d_delta[:, None])
    return jx, jy


def _host_rows(dp, host):
    return dp[torch.clamp(host.long(), 0, dp.shape[0] - 1)]


def _jdelta(fz, jx, jy, dp_pf):
    return (fz.JIdx[..., 0] * jx[..., None] + fz.JIdx[..., 1] * jy[..., None]
            + fz.JabF[..., 0] * dp_pf[..., None, 6]
            + fz.JabF[..., 1] * dp_pf[..., None, 7])


def fix_linearization(lin: Linearization, frames, calib, host, is_linearized,
                      AH, AT, d_delta=None) -> FrozenResiduals:
    """res_toZero = resF - [JI*Jp | Jab] * delta (fixLinearizationF)."""
    dp, c_delta = pair_deltas(frames, calib, AH, AT)
    dp_pf = _host_rows(dp, host)
    if d_delta is None:
        d_delta = torch.zeros(lin.resF.shape[0], device=lin.resF.device)
    jx, jy = _jp_delta(lin, dp_pf, c_delta, d_delta)
    return FrozenResiduals(
        Jpdc=lin.Jpdc, Jpdxi=lin.Jpdxi, Jpdd=lin.Jpdd, JIdx=lin.JIdx,
        JabF=lin.JabF, res_toZero=lin.resF - _jdelta(lin, jx, jy, dp_pf),
        is_linearized=is_linearized)


def frozen_resapprox(frozen: FrozenResiduals, frames, calib, host, AH, AT,
                     d_delta=None):
    dp, c_delta = pair_deltas(frames, calib, AH, AT)
    dp_pf = _host_rows(dp, host)
    if d_delta is None:
        d_delta = torch.zeros(frozen.res_toZero.shape[0], device=dp.device)
    jx, jy = _jp_delta(frozen, dp_pf, c_delta, d_delta)
    return frozen.res_toZero + _jdelta(frozen, jx, jy, dp_pf)


def accumulate_frozen(frozen: FrozenResiduals, frames, calib, host, AH, AT,
                      n_frames: int, d_delta=None) -> GNSystem:
    resapprox = frozen_resapprox(frozen, frames, calib, host, AH, AT, d_delta)
    P, F = frozen.is_linearized.shape
    z = torch.zeros((P, F), device=resapprox.device)
    nb = torch.zeros((P, F), dtype=torch.bool, device=resapprox.device)
    lin = Linearization(
        Jpdc=frozen.Jpdc, Jpdxi=frozen.Jpdxi, Jpdd=frozen.Jpdd,
        JIdx=frozen.JIdx, JabF=frozen.JabF, resF=resapprox,
        energy=z, energy_raw=z, new_state=z.to(torch.int32),
        center_u=z, center_v=z, center_idepth=z, rel_bs=z, win_miss=nb,
        ind_res=torch.zeros((P, F, 2), device=z.device), ind_wgt=z,
        ind_ok=nb, ind_energy=z)
    return accumulate(lin, frozen.is_linearized, host, AH, AT, n_frames)


def add_systems(a: GNSystem, b: GNSystem) -> GNSystem:
    return GNSystem(H=a.H + b.H, b=a.b + b.b, Hdd=a.Hdd + b.Hdd,
                    bd=a.bd + b.bd, g=a.g + b.g, num_res=a.num_res + b.num_res)


def calc_l_energy(frozen: FrozenResiduals, frames, calib, host, AH, AT,
                  point_prior, d_delta=None):
    if d_delta is None:
        d_delta = torch.zeros(frozen.res_toZero.shape[0], device=point_prior.device)
    dp, c_delta = pair_deltas(frames, calib, AH, AT)
    dp_pf = _host_rows(dp, host)
    jx, jy = _jp_delta(frozen, dp_pf, c_delta, d_delta)
    jd = _jdelta(frozen, jx, jy, dp_pf)
    terms = jd * (jd + 2.0 * frozen.res_toZero)
    e_res = torch.where(frozen.is_linearized[..., None], terms,
                        torch.zeros_like(terms)).sum()
    return e_res + (d_delta * d_delta * point_prior).sum()


def calc_m_energy(HM, bM, delta):
    return delta @ (2.0 * bM + HM @ delta)
