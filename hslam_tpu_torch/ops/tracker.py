"""Coarse frame-to-keyframe direct image alignment (port of
hslam_tpu/ops/tracker.py: nearest_template_depth, build_template,
_residual_pass, track_coarse, score_hypotheses, track_coarse_multi,
motion_hypotheses_device and the fused per-frame track_step).

Semantics follow the JAX package line by line; what changes is control
flow. The JAX `lax.while_loop`s (cutoff doubling, the per-level LM loop)
become Python loops whose exit test reads a device scalar: each such read is
a host sync, marked `# host sync` below. Levels that the JAX code runs under
an all-False `active` mask (tracker.py:448-467) are skipped here: their
results were discarded there, so the returned result is the same. The
`vmap` over motion hypotheses in score_hypotheses is a leading batch
dimension, with one batched 8x8 solve per iteration.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..config import Config, SCALE_A, SCALE_B, SCALE_XI_ROT, SCALE_XI_TRANS
from ..models.calib import k_pyr_from_value
from ..utils import lie
from ..utils.interp import pack_cells
from ..utils.segsum import bin_sums
from .pyramid import build_direct_pyramid

# tracker preconditioner, ordering [trans(3), rot(3), a, b] (the reference's
# rot/trans scale swap, see the JAX module docstring)
_PRECOND = [SCALE_XI_ROT] * 3 + [SCALE_XI_TRANS] * 3 + [SCALE_A, SCALE_B]

TEMPLATE_CAP = 8192


class Template(NamedTuple):
    u: List[torch.Tensor]        # (C_l,) pixel x per level
    v: List[torch.Tensor]
    idepth: List[torch.Tensor]
    color: List[torch.Tensor]
    valid: List[torch.Tensor]    # (C_l,) bool


def nearest_template_depth(ku, kv, tu, tv, tid, tval):
    """Nearest valid template point per keypoint (the depth lift of
    relocalization and the keyframe bundle). Returns (idepth (K,), squared
    pixel distance (K,)); callers gate on the distance (<= 9 px^2)."""
    d2 = (ku[:, None] - tu[None, :]) ** 2 + (kv[:, None] - tv[None, :]) ** 2
    d2 = torch.where(tval[None, :], d2, torch.full_like(d2, 1e12))
    nn = d2.argmin(dim=1)                  # the first minimum, as jnp.argmin
    return tid[nn], d2.amin(dim=1)


def rel_affine(exp_ref, exp_new, aff_ref, aff_new):
    """AffLight::fromToVecExposure. aff_new may carry leading batch dims."""
    t_ref = torch.where(exp_ref == 0, torch.ones_like(exp_ref), exp_ref)
    t_new = torch.where(exp_new == 0, torch.ones_like(exp_new), exp_new)
    a = torch.exp(aff_new[..., 0] - aff_ref[0]) * t_new / t_ref
    b = aff_new[..., 1] - a * aff_ref[1]
    return a, b


def _sum_pool2(m):
    H2, W2 = m.shape[0] // 2, m.shape[1] // 2
    return m[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2).sum(dim=(1, 3))


def build_template(u, v, idepth, weight, point_valid,
                   ref_pyr: List[torch.Tensor]) -> Template:
    """Per-level compacted tracking template from the active points
    projected into the reference keyframe (makeCoarseDepthL0)."""
    H0, W0 = ref_pyr[0].shape[:2]
    ui = torch.clamp((u + 0.5).to(torch.int32), 0, W0 - 1).long()
    vi = torch.clamp((v + 0.5).to(torch.int32), 0, H0 - 1).long()
    w_eff = torch.where(point_valid, weight, torch.zeros_like(weight))
    # fixed-order sums: the same template bits on every run (C11)
    sums = bin_sums(vi * W0 + ui, torch.stack([w_eff * idepth, w_eff], -1), H0 * W0)
    id_map = sums[:, 0].reshape(H0, W0)
    w_map = sums[:, 1].reshape(H0, W0)
    dev = u.device

    us, vs, idepths, colors, valids = [], [], [], [], []
    for lvl in range(len(ref_pyr)):
        if lvl > 0:
            id_map = _sum_pool2(id_map)
            w_map = _sum_pool2(w_map)
        shifts = ([(1, 1), (-1, -1), (1, -1), (-1, 1)] if lvl < 2
                  else [(0, 1), (0, -1), (1, 0), (-1, 0)])
        has = w_map > 0
        sum_id = torch.zeros_like(id_map)
        sum_w = torch.zeros_like(w_map)
        cnt = torch.zeros_like(w_map)
        for dy, dx in shifts:
            sh_w = torch.roll(w_map, (-dy, -dx), dims=(0, 1))
            sh_id = torch.roll(id_map, (-dy, -dx), dims=(0, 1))
            ok = sh_w > 0
            sum_id = sum_id + torch.where(ok, sh_id, 0.0)
            sum_w = sum_w + torch.where(ok, sh_w, 0.0)
            cnt = cnt + ok.float()
        fill = (~has) & (cnt > 0)
        safe_cnt = torch.clamp(cnt, min=1.0)
        id_lvl = torch.where(fill, sum_id / safe_cnt, id_map)
        w_lvl = torch.where(fill, sum_w / safe_cnt, w_map)

        Hl, Wl = id_lvl.shape
        ys = torch.arange(Hl, device=dev)[:, None]
        xs = torch.arange(Wl, device=dev)[None, :]
        border_ok = (ys >= 2) & (ys < Hl - 2) & (xs >= 2) & (xs < Wl - 2)
        idl = torch.where(w_lvl > 0, id_lvl / torch.clamp(w_lvl, min=1e-12),
                          torch.full_like(id_lvl, -1.0))
        color = ref_pyr[lvl][..., 0]
        ok = (w_lvl > 0) & (idl > 0) & border_ok & torch.isfinite(color)

        # compaction to a fixed-capacity list: valid pixels first, each group
        # in index order (the tie order of lax.top_k on a 0/1 score)
        cap = min(Hl * Wl, TEMPLATE_CAP)
        okf = ok.reshape(-1)
        top_idx = torch.argsort((~okf).to(torch.int8), stable=True)[:cap]
        us.append((top_idx % Wl).float())
        vs.append(torch.div(top_idx, Wl, rounding_mode="floor").float())
        idepths.append(idl.reshape(-1)[top_idx])
        colors.append(color.reshape(-1)[top_idx])
        valids.append(okf[top_idx])
    return Template(u=us, v=vs, idepth=idepths, color=colors, valid=valids)


class TrackResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    aff: torch.Tensor
    ok: torch.Tensor
    residuals: torch.Tensor         # (L,)
    flow: torch.Tensor              # (3,)


def pack_pyramid_level(img3: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> (H, W, 3, 4) per-pixel 2x2 interpolation cells."""
    return torch.stack([pack_cells(img3[..., c]) for c in range(3)], dim=2)


def _residual_pass(tmpl_u, tmpl_v, tmpl_id, tmpl_color, tmpl_valid,
                   target_img, K_lvl, R, t, a_rel, b_rel, b0, cutoff,
                   huber_th, compute_flow: bool):
    """Warp the template points, gather target [I, dx, dy] from the packed
    cells, robust residuals and the 8x8 GN system in one pass.

    R (..., 3, 3), t (..., 3), a_rel/b_rel (...) may carry a leading batch
    dimension (one per motion hypothesis). Returns (E, n_terms, n_sat,
    H (..., 8, 8), b (..., 8), flowT, flowRT)."""
    Hl, Wl = target_img.shape[0], target_img.shape[1]
    fx, fy, cx, cy = K_lvl[0], K_lvl[1], K_lvl[2], K_lvl[3]

    def e(x):      # per-hypothesis scalar -> broadcast over points
        return x[..., None]

    xs, ys, idp = tmpl_u, tmpl_v, tmpl_id
    px = (xs - cx) / fx
    py = (ys - cy) / fy
    X = e(R[..., 0, 0]) * px + e(R[..., 0, 1]) * py + e(R[..., 0, 2]) + e(t[..., 0]) * idp
    Y = e(R[..., 1, 0]) * px + e(R[..., 1, 1]) * py + e(R[..., 1, 2]) + e(t[..., 1]) * idp
    Z = e(R[..., 2, 0]) * px + e(R[..., 2, 1]) * py + e(R[..., 2, 2]) + e(t[..., 2]) * idp

    Zs = torch.where(Z.abs() < 1e-12, torch.full_like(Z, 1e-12), Z)
    u = X / Zs
    v = Y / Zs
    Ku = fx * u + cx
    Kv = fy * v + cy
    new_idepth = idp / Zs

    in_bounds = (Ku > 2) & (Kv > 2) & (Ku < Wl - 3) & (Kv < Hl - 3) & (new_idepth > 0)
    mask = tmpl_valid & in_bounds

    Kuc = torch.clamp(Ku, 0.0, Wl - 1.001)
    Kvc = torch.clamp(Kv, 0.0, Hl - 1.001)
    ix = torch.clamp(torch.floor(Kuc).long(), 0, Wl - 2)
    iy = torch.clamp(torch.floor(Kvc).long(), 0, Hl - 2)
    dx_f = Kuc - ix.float()
    dy_f = Kvc - iy.float()
    cells = target_img.reshape(Hl * Wl, 3, 4)[iy * Wl + ix]   # (..., C, 3, 4)
    wx = dx_f[..., None]
    wy = dy_f[..., None]
    top = cells[..., 0] * (1 - wx) + cells[..., 1] * wx
    bot = cells[..., 2] * (1 - wx) + cells[..., 3] * wx
    hit = top * (1 - wy) + bot * wy                              # (..., C, 3)
    hit_I, hit_dx, hit_dy = hit[..., 0], hit[..., 1], hit[..., 2]
    mask = mask & torch.isfinite(hit_I)

    refc = tmpl_color
    residual = hit_I - (e(a_rel) * refc + e(b_rel))
    abs_r = residual.abs()
    hw = torch.where(abs_r < huber_th, torch.ones_like(abs_r),
                     huber_th / torch.clamp(abs_r, min=1e-12))
    saturated = (abs_r > cutoff) & mask
    inlier = mask & ~saturated

    max_energy = 2.0 * huber_th * cutoff - huber_th * huber_th
    zero = torch.zeros_like(residual)
    E = torch.sum(torch.where(inlier, hw * residual * residual * (2.0 - hw), zero)
                  + torch.where(saturated, max_energy, zero), dim=-1)
    n_terms = mask.float().sum(-1)
    n_sat = saturated.float().sum(-1)

    m = inlier.float()
    gdx = hit_dx * fx
    gdy = hit_dy * fy
    J = torch.stack(
        [
            new_idepth * gdx,
            new_idepth * gdy,
            -new_idepth * (u * gdx + v * gdy),
            -(u * v * gdx + (1.0 + v * v) * gdy),
            u * v * gdy + (1.0 + u * u) * gdx,
            u * gdy - v * gdx,
            e(a_rel) * (b0 - refc).expand_as(u),
            -torch.ones_like(u),
        ],
        dim=-1,
    )  # (..., C, 8)
    Jw = J * (hw * m)[..., None]
    Jt = J.transpose(-1, -2)
    Hmat = Jt @ Jw
    bvec = (Jt @ (residual * hw * m)[..., None])[..., 0]

    if compute_flow:
        tx = px + e(t[..., 0]) * idp
        ty = py + e(t[..., 1]) * idp
        tz = 1.0 + e(t[..., 2]) * idp
        tzs = torch.where(tz.abs() < 1e-12, torch.full_like(tz, 1e-12), tz)
        KuT = fx * tx / tzs + cx
        KvT = fy * ty / tzs + cy
        tx2 = px - e(t[..., 0]) * idp
        ty2 = py - e(t[..., 1]) * idp
        tz2 = 1.0 - e(t[..., 2]) * idp
        tz2s = torch.where(tz2.abs() < 1e-12, torch.full_like(tz2, 1e-12), tz2)
        KuT2 = fx * tx2 / tz2s + cx
        KvT2 = fy * ty2 / tz2s + cy
        X3 = X - 2.0 * e(t[..., 0]) * idp
        Y3 = Y - 2.0 * e(t[..., 1]) * idp
        Z3 = Z - 2.0 * e(t[..., 2]) * idp
        Z3s = torch.where(Z3.abs() < 1e-12, torch.full_like(Z3, 1e-12), Z3)
        Ku3 = fx * X3 / Z3s + cx
        Kv3 = fy * Y3 / Z3s + cy
        fm = tmpl_valid.float()
        fn = fm.sum()
        shiftT = torch.sum(fm * ((KuT - xs) ** 2 + (KvT - ys) ** 2
                                 + (KuT2 - xs) ** 2 + (KvT2 - ys) ** 2), dim=-1)
        shiftRT = torch.sum(fm * ((Ku - xs) ** 2 + (Kv - ys) ** 2
                                  + (Ku3 - xs) ** 2 + (Kv3 - ys) ** 2), dim=-1)
        flowT = shiftT / (2.0 * fn + 0.1)
        flowRT = shiftRT / (2.0 * fn + 0.1)
    else:
        flowT = torch.zeros_like(E)
        flowRT = torch.zeros_like(E)
    return E, n_terms, n_sat, Hmat, bvec, flowT, flowRT


def _solve8(Hc, bc, lam):
    """LM step: (H + diag(H) lam) inc = -b, batched; a singular system
    gives non-finite entries (no exception), caught by the callers."""
    dg = torch.diagonal(Hc, dim1=-2, dim2=-1)
    Hl = Hc + torch.diag_embed(dg * lam[..., None])
    inc, _ = torch.linalg.solve_ex(Hl, -bc)
    return inc


def track_coarse(template: Template, target_pyr: List[torch.Tensor],
                 K_pyr: torch.Tensor, R0, t0, aff0, exp_ref, exp_new, aff_ref,
                 cfg: Config, coarsest_lvl: Optional[int] = None,
                 min_res_for_abort: Optional[torch.Tensor] = None,
                 packed_pyr: Optional[List[torch.Tensor]] = None) -> TrackResult:
    """Coarse-to-fine LM alignment of one motion hypothesis
    (trackNewestCoarse): cutoff doubling, per-level iteration caps, lambda
    schedule, extrapolation, early abort and the affine sanity check."""
    dev = R0.device
    n_levels = len(target_pyr)
    if coarsest_lvl is None:
        coarsest_lvl = n_levels - 1
    if min_res_for_abort is None:
        min_res_for_abort = torch.full((n_levels,), float("inf"), device=dev)
    min_abort_h = min_res_for_abort.tolist()                      # host sync
    huber = cfg.huber_th
    b0_ref = aff_ref[1]
    max_iters = cfg.tracker_iters_per_level
    precond = torch.tensor(_PRECOND, dtype=torch.float32, device=dev)
    if packed_pyr is None:
        packed_pyr = [pack_pyramid_level(t) for t in target_pyr]

    R, t, aff = R0, t0, aff0
    nan = torch.tensor(float("nan"), device=dev)
    level_res = [nan] * n_levels
    flow = torch.tensor([1000.0, 0.0, 1000.0], device=dev)

    def run_level(lvl, R, t, aff):
        tm = (template.u[lvl], template.v[lvl], template.idepth[lvl],
              template.color[lvl], template.valid[lvl])
        timg = packed_pyr[lvl]
        K_lvl = K_pyr[lvl]

        def res_at(R_, t_, aff_, cutoff, with_flow=False):
            a_rel, b_rel = rel_affine(exp_ref, exp_new, aff_ref, aff_)
            return _residual_pass(*tm, timg, K_lvl, R_, t_, a_rel, b_rel,
                                  b0_ref, cutoff, huber, with_flow)

        base_cut = cfg.coarse_cutoff_th
        E, n, nsat, Hm, bv, *_ = res_at(R, t, aff, base_cut)
        cut_rep = 1.0
        # adaptive cutoff doubling (CoarseTracker.cpp:530-539)
        while float(nsat / torch.clamp(n, min=1.0)) > 0.6 and cut_rep < 50.0:  # host sync
            cut_rep *= 2.0
            E, n, nsat, Hm, bv, *_ = res_at(R, t, aff, base_cut * cut_rep)
        cutoff = base_cut * cut_rep

        lam = torch.tensor(0.01, device=dev)
        n_it = max_iters[min(lvl, len(max_iters) - 1)]
        for _ in range(n_it):
            inc = _solve8(Hm, bv, lam)
            extrap = torch.where(lam < 0.001,
                                 torch.sqrt(torch.sqrt(0.001 / torch.clamp(lam, min=1e-12))),
                                 torch.ones_like(lam))
            inc_s = inc * extrap
            inc_s = torch.where(torch.isfinite(inc_s.sum()), inc_s, torch.zeros_like(inc_s))
            dR, dt = lie.se3_exp(inc_s[:6])
            R_new, t_new = lie.se3_mul(dR, dt, R, t)
            aff_new = aff + inc_s[6:8]
            E_new, n_new, _, H_new, b_new, *_ = res_at(R_new, t_new, aff_new, cutoff)
            accept = (E_new / torch.clamp(n_new, min=1.0)) < (E / torch.clamp(n, min=1.0))
            R = torch.where(accept, R_new, R)
            t = torch.where(accept, t_new, t)
            aff = torch.where(accept, aff_new, aff)
            Hm = torch.where(accept, H_new, Hm)
            bv = torch.where(accept, b_new, bv)
            E = torch.where(accept, E_new, E)
            n = torch.where(accept, n_new, n)
            lam = torch.where(accept, lam * 0.5, torch.clamp(lam * 4.0, min=0.001))
            # convergence in the reference's scaled units (CoarseTracker.cpp:640)
            if float(torch.linalg.norm(inc_s / precond)) <= 1e-3:   # host sync
                break

        E_fin, n_fin, _, _, _, flowT, flowRT = res_at(R, t, aff, cutoff, True)
        rmse = torch.sqrt(E_fin / torch.clamp(n_fin, min=1.0))
        return R, t, aff, rmse, torch.stack([flowT, torch.zeros_like(flowT), flowRT]), cut_rep

    ok = True
    have_repeated = False
    for lvl in range(coarsest_lvl, -1, -1):
        if not ok:
            # the JAX code runs the level masked out and discards it
            continue
        R, t, aff, rmse, flow, cut_rep = run_level(lvl, R, t, aff)
        level_res[lvl] = rmse
        abort_lvl = min(lvl, len(min_abort_h) - 1)
        rmse_h = float(rmse)                                       # host sync
        ok = not (rmse_h > 1.5 * min_abort_h[abort_lvl])
        # repeat-level-once (CoarseTracker.cpp:654-659)
        if ok and cut_rep > 1.0 and not have_repeated:
            have_repeated = True
            R, t, aff, rmse_r, flow, _ = run_level(lvl, R, t, aff)
            level_res[lvl] = rmse_r

    ok_t = torch.tensor(ok, device=dev)
    ok_t = ok_t & (aff[0].abs() <= 1.2) & (aff[1].abs() <= 200.0)
    return TrackResult(R=R, t=t, aff=aff, ok=ok_t,
                       residuals=torch.stack(level_res), flow=flow)


def score_hypotheses(template: Template, coarse_img: torch.Tensor, K_lvl,
                     lvl: int, R_b, t_b, aff0, exp_ref, exp_new, aff_ref,
                     cfg: Config, n_iters: int = 10,
                     packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed-iteration GN of all N hypotheses at the coarsest level, as one
    batch. Returns (N,) mean energy E/n, inf for diverged hypotheses."""
    if packed is None:
        packed = pack_pyramid_level(coarse_img)
    tm = (template.u[lvl], template.v[lvl], template.idepth[lvl],
          template.color[lvl], template.valid[lvl])
    huber = cfg.huber_th
    cutoff = cfg.coarse_cutoff_th
    b0_ref = aff_ref[1]
    N = R_b.shape[0]

    def res_at(R_, t_, aff_):
        a_r, b_r = rel_affine(exp_ref, exp_new, aff_ref, aff_)
        return _residual_pass(*tm, packed, K_lvl, R_, t_, a_r, b_r, b0_ref,
                              cutoff, huber, False)

    R, t = R_b, t_b
    aff = aff0.expand(N, 2)
    E, n, _, Hm, bv, *_ = res_at(R, t, aff)
    lam = torch.full((N,), 0.01, device=R_b.device)
    for _ in range(n_iters):
        inc = _solve8(Hm, bv, lam)
        inc = torch.where(torch.isfinite(inc.sum(-1, keepdim=True)), inc,
                          torch.zeros_like(inc))
        dR, dt = lie.se3_exp(inc[:, :6])
        R_n, t_n = lie.se3_mul(dR, dt, R, t)
        aff_n = aff + inc[:, 6:8]
        E_n, n_n, _, H_n, b_n, *_ = res_at(R_n, t_n, aff_n)
        acc = (E_n / torch.clamp(n_n, min=1.0)) < (E / torch.clamp(n, min=1.0))
        R = torch.where(acc[:, None, None], R_n, R)
        t = torch.where(acc[:, None], t_n, t)
        aff = torch.where(acc[:, None], aff_n, aff)
        Hm = torch.where(acc[:, None, None], H_n, Hm)
        bv = torch.where(acc[:, None], b_n, bv)
        E = torch.where(acc, E_n, E)
        n = torch.where(acc, n_n, n)
        lam = torch.where(acc, lam * 0.5, torch.clamp(lam * 4.0, min=0.001))
    mean_e = E / torch.clamp(n, min=1.0)
    bad = ~torch.isfinite(mean_e) | (n < 4.0)
    return torch.where(bad, torch.full_like(mean_e, float("inf")), mean_e)


def track_coarse_multi(template: Template, target_pyr: List[torch.Tensor],
                       K_pyr, R_b, t_b, aff0, exp_ref, exp_new, aff_ref,
                       cfg: Config, coarsest_lvl: Optional[int] = None,
                       min_res_for_abort=None) -> Tuple[TrackResult, torch.Tensor]:
    """Score every hypothesis at the coarsest level, then run the full
    coarse-to-fine LM on the argmin. Returns (result, best_idx)."""
    n_levels = len(target_pyr)
    if coarsest_lvl is None:
        coarsest_lvl = n_levels - 1
    packed_pyr = [pack_pyramid_level(t) for t in target_pyr]
    scores = score_hypotheses(
        template, target_pyr[coarsest_lvl], K_pyr[coarsest_lvl], coarsest_lvl,
        R_b, t_b, aff0, exp_ref, exp_new, aff_ref, cfg,
        packed=packed_pyr[coarsest_lvl])
    best = torch.argmin(scores)
    res = track_coarse(template, target_pyr, K_pyr, R_b[best], t_b[best], aff0,
                       exp_ref, exp_new, aff_ref, cfg, coarsest_lvl=coarsest_lvl,
                       min_res_for_abort=min_res_for_abort,
                       packed_pyr=packed_pyr)
    return res._replace(ok=res.ok & torch.isfinite(scores[best])), best


def _rigid_inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid 4x4 (or batch of them)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    Ti = torch.zeros_like(T)
    Ti[..., :3, :3] = Rt
    Ti[..., :3, 3] = -(Rt @ T[..., :3, 3:4])[..., 0]
    Ti[..., 3, 3] = 1.0
    return Ti


# the reference's 26 small-rotation perturbations (System.cpp:374-405)
_ROT_AXES = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), (0, -1, 0), (0, 0, -1),
             (1, 1, 0), (0, 1, 1), (1, 0, 1), (-1, 1, 0), (0, -1, 1), (-1, 0, 1),
             (1, -1, 0), (0, 1, -1), (1, 0, -1), (-1, -1, 0), (0, -1, -1), (-1, 0, -1),
             (-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1), (1, -1, -1), (1, -1, 1),
             (1, 1, -1), (1, 1, 1)]


def _se3_4x4(R, t):
    T = torch.eye(4, dtype=R.dtype, device=R.device).repeat(R.shape[:-2] + (1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def motion_hypotheses_device(ref_c2w, prev_c2w, prevprev_c2w, have_motion,
                             rot: float = 0.02, dt_ratio=None):
    """The reference's motion-hypothesis list built on the device from the
    last two camera poses: constant, double and half motion (the twist
    scaled by the timestamp-gap ratio `dt_ratio`), zero motion from the last
    frame and from the reference, and 26 rotation perturbations of the
    constant-motion guess. refToNew as (32, 3, 3), (32, 3); all identity
    when `have_motion` is False."""
    dev = ref_c2w.device
    fh2slast = _rigid_inv(prevprev_c2w) @ prev_c2w
    T_ls = _rigid_inv(prev_c2w) @ ref_c2w
    r = torch.ones((), device=dev) if dt_ratio is None else torch.as_tensor(
        dt_ratio, dtype=torch.float32, device=dev)
    xi = lie.se3_log(fh2slast[:3, :3], fh2slast[:3, 3])
    f = torch.stack([-r, -2.0 * r, -0.5 * r])
    Rf, tf = lie.se3_exp(f[:, None] * xi[None])
    fwd = _se3_4x4(Rf, tf)                     # exp(f xi) for the three f
    base = fwd[0] @ T_ls
    quats = torch.cat([torch.ones((26, 1), device=dev),
                       rot * torch.tensor(_ROT_AXES, dtype=torch.float32, device=dev)], 1)
    quats = quats / torch.linalg.norm(quats, dim=1, keepdim=True)
    R_pert = lie.quat_to_rot(torch.cat([quats[:, 1:], quats[:, :1]], 1))
    pert = _se3_4x4(R_pert, torch.zeros((26, 3), device=dev))
    eye = torch.eye(4, device=dev)
    T_all = torch.cat([torch.stack([base, fwd[1] @ T_ls, fwd[2] @ T_ls, T_ls, eye]),
                       base @ pert, base[None]], 0)                 # (32, 4, 4)
    T_all = torch.where(torch.as_tensor(have_motion, device=dev), T_all, eye.expand(32, 4, 4))
    return T_all[:, :3, :3], T_all[:, :3, 3]


class TrackStepOut(NamedTuple):
    pyr: List[torch.Tensor]
    grads: List[torch.Tensor]
    R: torch.Tensor                 # (3, 3) refToNew
    t: torch.Tensor
    aff: torch.Tensor
    ok: torch.Tensor
    residuals: torch.Tensor
    flow: torch.Tensor
    c2w: torch.Tensor               # (4, 4) new camToWorld


def track_step(template: Template, img: torch.Tensor, calib_value, ref_c2w,
               prev_c2w, prevprev_c2w, have_motion, aff0, exp_ref, exp_new,
               aff_ref, cfg: Config, n_levels: int,
               gamma_grad_weight: Optional[torch.Tensor] = None,
               dt_ratio=None) -> TrackStepOut:
    """One per-frame tracking step: pyramid (the CUDA kernel on a CUDA
    image), device-side motion hypotheses, batched coarsest-level scoring
    and the coarse-to-fine LM. `img` may be uint8; c2w feeds the next
    frame's hypotheses without a host round trip. `gamma_grad_weight`
    re-weights the gradient maps (photometric calibration)."""
    K_pyr = k_pyr_from_value(calib_value, n_levels)
    pyr, grads = build_direct_pyramid(img, n_levels, gamma_grad_weight)
    R_b, t_b = motion_hypotheses_device(ref_c2w, prev_c2w, prevprev_c2w, have_motion,
                                        dt_ratio=dt_ratio)
    res, _ = track_coarse_multi(template, pyr, K_pyr, R_b, t_b, aff0, exp_ref, exp_new,
                                aff_ref, cfg, coarsest_lvl=n_levels - 1)
    c2w = ref_c2w @ _rigid_inv(_se3_4x4(res.R, res.t))
    return TrackStepOut(pyr=pyr, grads=grads, R=res.R, t=res.t, aff=res.aff, ok=res.ok,
                        residuals=res.residuals, flow=res.flow, c2w=c2w)
