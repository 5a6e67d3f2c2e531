"""Coarse frame-to-keyframe direct image alignment (port of
hslam_tpu/ops/tracker.py: nearest_template_depth, build_template,
_residual_pass, track_coarse, score_hypotheses, track_coarse_multi,
motion_hypotheses_device and the fused per-frame track_step).

`track_coarse` and `score_hypotheses` have two routes. For CUDA tensors
each is one launch of the hand-written kernels in csrc/tracker.cu (the
whole coarse-to-fine LM in one thread block; one block per hypothesis for
the scoring), with no host read until the caller pulls the result; a
refused launch raises. For CPU tensors, and only there, the plain versions
below run. `kernel_launches` and `plain_calls` count the two routes.

The plain versions follow the JAX package line by line; what changes is
control flow. The JAX `lax.while_loop`s (cutoff doubling, the per-level LM
loop) become Python loops whose exit test reads a device scalar: each such
read is a host sync, marked `# host sync` below. Levels that the JAX code
runs under an all-False `active` mask (tracker.py:448-467) are skipped
here: their results were discarded there, so the returned result is the
same. The `vmap` over motion hypotheses in score_hypotheses is a leading
batch dimension, with one batched 8x8 solve per iteration.

Both routes return the LM's iterations and cutoff doublings per level as a
small int tensor (`TrackResult.lm`); the system counts `lm_iter` and
`lm_cutoff_double` from it when it pulls the result.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..config import Config, SCALE_A, SCALE_B, SCALE_XI_ROT, SCALE_XI_TRANS
from ..models.calib import k_pyr_from_value
from ..utils import lie, trace
from ..utils.interp import pack_cells
from ..utils.segsum import bin_sums
from .pyramid import build_direct_pyramid

# tracker preconditioner, ordering [trans(3), rot(3), a, b] (the reference's
# rot/trans scale swap, see the JAX module docstring)
_PRECOND = [SCALE_XI_ROT] * 3 + [SCALE_XI_TRANS] * 3 + [SCALE_A, SCALE_B]

TEMPLATE_CAP = 8192
MAX_LEVELS = 8          # the kernels take the levels as a fixed-size array
SCORE_ITERS = 10        # score_hypotheses' fixed GN/LM iterations

kernel_launches = 0     # launches of the kernels (scoring and coarse-to-fine)
plain_calls = 0         # calls of the plain track_coarse and score_hypotheses

_fns = None            # (score, coarse) entries of the built csrc/tracker.cu
_count_lock = threading.Lock()


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
    lm: Optional[torch.Tensor] = None   # (2, L) int32: LM iterations, cutoff doublings


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


def _pull_float(x: torch.Tensor) -> float:
    """float() of a device scalar: the host waits for the card here."""
    trace.count("host_sync")
    return float(x)


def _solve8(Hc, bc, lam):
    """LM step: (H + diag(H) lam) inc = -b, batched; a singular system
    gives non-finite entries (no exception), caught by the callers."""
    dg = torch.diagonal(Hc, dim1=-2, dim2=-1)
    Hl = Hc + torch.diag_embed(dg * lam[..., None])
    inc, _ = torch.linalg.solve_ex(Hl, -bc)
    return inc


def track_coarse_plain(template: Template, target_pyr: List[torch.Tensor],
                       K_pyr: torch.Tensor, R0, t0, aff0, exp_ref, exp_new, aff_ref,
                       cfg: Config, coarsest_lvl: Optional[int] = None,
                       min_res_for_abort: Optional[torch.Tensor] = None,
                       packed_pyr: Optional[List[torch.Tensor]] = None) -> TrackResult:
    """The plain version of track_coarse (torch ops launched from the host,
    a host sync per LM iteration); runs on any device."""
    dev = R0.device
    n_levels = len(target_pyr)
    if coarsest_lvl is None:
        coarsest_lvl = n_levels - 1
    if min_res_for_abort is None:
        min_res_for_abort = torch.full((n_levels,), float("inf"), device=dev)
    trace.count("host_sync")
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
    lm = [[0] * n_levels, [0] * n_levels]         # iterations, cutoff doublings per level

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
        while _pull_float(nsat / torch.clamp(n, min=1.0)) > 0.6 and cut_rep < 50.0:  # host sync
            lm[1][lvl] += 1
            cut_rep *= 2.0
            E, n, nsat, Hm, bv, *_ = res_at(R, t, aff, base_cut * cut_rep)
        cutoff = base_cut * cut_rep

        lam = torch.tensor(0.01, device=dev)
        n_it = max_iters[min(lvl, len(max_iters) - 1)]
        for _ in range(n_it):
            lm[0][lvl] += 1
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
            if _pull_float(torch.linalg.norm(inc_s / precond)) <= 1e-3:   # host sync
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
        with trace.span("track.level", level=lvl, repeat=False):
            R, t, aff, rmse, flow, cut_rep = run_level(lvl, R, t, aff)
            level_res[lvl] = rmse
            abort_lvl = min(lvl, len(min_abort_h) - 1)
            rmse_h = _pull_float(rmse)                             # host sync
        ok = not (rmse_h > 1.5 * min_abort_h[abort_lvl])
        # repeat-level-once (CoarseTracker.cpp:654-659)
        if ok and cut_rep > 1.0 and not have_repeated:
            have_repeated = True
            with trace.span("track.level", level=lvl, repeat=True):
                R, t, aff, rmse_r, flow, _ = run_level(lvl, R, t, aff)
            level_res[lvl] = rmse_r

    ok_t = torch.tensor(ok, device=dev)
    ok_t = ok_t & (aff[0].abs() <= 1.2) & (aff[1].abs() <= 200.0)
    return TrackResult(R=R, t=t, aff=aff, ok=ok_t, residuals=torch.stack(level_res),
                       flow=flow, lm=torch.tensor(lm, dtype=torch.int32, device=dev))


def score_hypotheses_plain(template: Template, coarse_img: torch.Tensor, K_lvl,
                           lvl: int, R_b, t_b, aff0, exp_ref, exp_new, aff_ref,
                           cfg: Config, n_iters: int = SCORE_ITERS,
                           packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of score_hypotheses (all N hypotheses as one batch
    of torch ops); runs on any device."""
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


# ------------------------------------------------ the kernels (csrc/tracker.cu)
_vp = ctypes.c_void_p


class _Level(ctypes.Structure):
    """csrc/tracker.cu's `Level`, field for field."""
    _fields_ = [("u", _vp), ("v", _vp), ("idepth", _vp), ("color", _vp), ("valid", _vp),
                ("img", _vp), ("K", _vp), ("n", ctypes.c_int), ("H", ctypes.c_int),
                ("W", ctypes.c_int), ("max_iters", ctypes.c_int)]


class _Args(ctypes.Structure):
    """csrc/tracker.cu's `TrackArgs`, field for field."""
    _fields_ = [("lv", _Level * MAX_LEVELS), ("n_levels", ctypes.c_int),
                ("coarsest", ctypes.c_int), ("n_hyp", ctypes.c_int),
                ("score_iters", ctypes.c_int), ("R0", _vp), ("t0", _vp), ("aff0", _vp),
                ("exp_ref", _vp), ("exp_new", _vp), ("aff_ref", _vp), ("min_res", _vp),
                ("n_min_res", ctypes.c_int), ("precond", ctypes.c_float * 8),
                ("huber", ctypes.c_double), ("cutoff", ctypes.c_double), ("out", _vp),
                ("ok", _vp), ("rec", _vp)]


def bind_kernels(lib: ctypes.CDLL):
    """(score, coarse): the two C entries of a built csrc/tracker.cu, their
    argument types set; raises if the library's TrackArgs is not _Args."""
    size = lib.hslam_track_args_size
    size.argtypes = []
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(_Args):
        raise RuntimeError(f"csrc/tracker.cu's TrackArgs has {size()} bytes, "
                           f"ops/tracker._Args {ctypes.sizeof(_Args)}")
    fns = []
    for name in ("hslam_track_score", "hslam_track_coarse"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Args), _vp]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return tuple(fns)


def _kernels():
    global _fns
    if _fns is None:
        from .. import _cuda

        _fns = bind_kernels(_cuda.load("tracker"))
    return _fns


def _ptr(name: str, x, dev, numel: Optional[int] = None, shape=None,
         dtype=torch.float32) -> int:
    """x's pointer, once x is a contiguous `dtype` tensor on `dev` of the
    given element count or shape; raises ValueError on anything else."""
    if (not isinstance(x, torch.Tensor) or x.device != dev or x.dtype != dtype
            or not x.is_contiguous() or (numel is not None and x.numel() != numel)
            or (shape is not None and tuple(x.shape) != tuple(shape))):
        what = (f"{type(x).__name__}" if not isinstance(x, torch.Tensor) else
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
                f"{'' if x.is_contiguous() else ', not contiguous'}")
        want = (f" of shape {tuple(shape)}" if shape is not None else
                f" of {numel} elements" if numel is not None else "")
        raise ValueError(f"the tracker kernel takes {name} as a contiguous {dtype} "
                         f"tensor{want} on {dev}, got {what}")
    return x.data_ptr()


def _kernel_args(template: Template, levels: dict, R0, t0, aff0, exp_ref, exp_new,
                 aff_ref, cfg: Config, n_levels: int, coarsest: int, n_hyp: int = 0,
                 min_res=None) -> _Args:
    """The kernels' arguments, every tensor checked. `levels` maps each
    level the kernel reads to (target image (H, W, 3), its (4,) intrinsics);
    n_hyp > 0: R0 (n_hyp, 3, 3) and t0 (n_hyp, 3) are the hypotheses to
    score. The outputs are the caller's to set."""
    dev = R0.device if isinstance(R0, torch.Tensor) else None
    if not 1 <= n_levels <= MAX_LEVELS or not 0 <= coarsest < n_levels:
        raise ValueError(f"the tracker kernel takes 1..{MAX_LEVELS} levels and a coarsest "
                         f"level below them, got {n_levels} levels, coarsest {coarsest}")
    a = _Args()
    a.n_levels, a.coarsest, a.n_hyp, a.score_iters = n_levels, coarsest, n_hyp, SCORE_ITERS
    caps = cfg.tracker_iters_per_level
    n_tpl = len(template.u)
    for lvl, (img, K) in levels.items():
        if not 0 <= lvl < min(n_levels, n_tpl):
            raise ValueError(f"level {lvl} is outside the pyramid or the template")
        C = template.u[lvl].shape[0] if isinstance(template.u[lvl], torch.Tensor) else -1
        if not 0 <= C <= TEMPLATE_CAP:
            raise ValueError(f"the tracker kernel takes up to {TEMPLATE_CAP} template points "
                             f"a level, got {C} at level {lvl}")
        if (not isinstance(img, torch.Tensor) or img.dim() != 3 or img.shape[2] != 3
                or img.shape[0] < 2 or img.shape[1] < 2):
            raise ValueError(f"the tracker kernel takes a level as (H, W, 3), H, W >= 2, got "
                             f"{getattr(img, 'shape', type(img).__name__)} at level {lvl}")
        lv = a.lv[lvl]
        lv.u = _ptr("template.u", template.u[lvl], dev, numel=C)
        lv.v = _ptr("template.v", template.v[lvl], dev, numel=C)
        lv.idepth = _ptr("template.idepth", template.idepth[lvl], dev, numel=C)
        lv.color = _ptr("template.color", template.color[lvl], dev, numel=C)
        lv.valid = _ptr("template.valid", template.valid[lvl], dev, numel=C, dtype=torch.bool)
        lv.img = _ptr("a pyramid level", img, dev)
        lv.K = _ptr("a level's intrinsics", K, dev, numel=4)
        lv.n, lv.H, lv.W = C, img.shape[0], img.shape[1]
        lv.max_iters = caps[min(lvl, len(caps) - 1)]
    if n_hyp:
        a.R0 = _ptr("R_b", R0, dev, shape=(n_hyp, 3, 3))
        a.t0 = _ptr("t_b", t0, dev, shape=(n_hyp, 3))
    else:
        a.R0 = _ptr("R0", R0, dev, numel=9)
        a.t0 = _ptr("t0", t0, dev, numel=3)
    a.aff0 = _ptr("aff0", aff0, dev, numel=2)
    a.exp_ref = _ptr("exp_ref", exp_ref, dev, numel=1)
    a.exp_new = _ptr("exp_new", exp_new, dev, numel=1)
    a.aff_ref = _ptr("aff_ref", aff_ref, dev, numel=2)
    if min_res is not None:
        a.min_res = _ptr("min_res_for_abort", min_res, dev)
        a.n_min_res = min_res.numel()
        if a.n_min_res < 1:
            raise ValueError("min_res_for_abort is empty")
    a.precond[:] = _PRECOND
    a.huber, a.cutoff = float(cfg.huber_th), float(cfg.coarse_cutoff_th)
    return a


def _launch(fn, args: _Args, dev: torch.device) -> None:
    """One launch of a kernel entry on dev's current stream (the host
    build takes a CPU device and no stream); raises if it was refused."""
    global kernel_launches
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    err = fn(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"tracker kernel launch failed: cudaError {err}")
    with _count_lock:
        kernel_launches += 1


def track_coarse_kernel(template: Template, target_pyr: List[torch.Tensor], K_pyr, R0, t0,
                        aff0, exp_ref, exp_new, aff_ref, cfg: Config,
                        coarsest_lvl: Optional[int] = None,
                        min_res_for_abort=None) -> TrackResult:
    """track_coarse in one launch of csrc/tracker.cu's coarse-to-fine
    kernel."""
    dev = R0.device
    n_levels = len(target_pyr)
    coarsest = n_levels - 1 if coarsest_lvl is None else int(coarsest_lvl)
    if not isinstance(K_pyr, torch.Tensor) or K_pyr.dim() != 2 or K_pyr.shape[0] < n_levels:
        raise ValueError("the tracker kernel takes K_pyr as (L, 4), one row a level")
    levels = {lvl: (target_pyr[lvl], K_pyr[lvl])
              for lvl in range(min(coarsest, n_levels - 1) + 1)}
    a = _kernel_args(template, levels, R0, t0, aff0, exp_ref, exp_new, aff_ref, cfg,
                     n_levels, coarsest, min_res=min_res_for_abort)
    out = torch.empty(17 + n_levels, dtype=torch.float32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    lm = torch.empty((2, n_levels), dtype=torch.int32, device=dev)
    a.out, a.ok, a.rec = out.data_ptr(), ok.data_ptr(), lm.data_ptr()
    _launch(_kernels()[1], a, dev)
    trace.count("track_kernel")
    return TrackResult(R=out[:9].view(3, 3), t=out[9:12], aff=out[12:14], ok=ok,
                       residuals=out[14:14 + n_levels], flow=out[14 + n_levels:], lm=lm)


def score_hypotheses_kernel(template: Template, coarse_img, K_lvl, lvl: int, R_b, t_b, aff0,
                            exp_ref, exp_new, aff_ref, cfg: Config,
                            n_iters: int = SCORE_ITERS) -> torch.Tensor:
    """score_hypotheses in one launch of csrc/tracker.cu's scoring kernel,
    one block per hypothesis."""
    dev = R_b.device
    N = R_b.shape[0] if isinstance(R_b, torch.Tensor) and R_b.dim() == 3 else 0
    if N < 1:
        raise ValueError("the scoring kernel takes R_b as (N, 3, 3), N >= 1")
    a = _kernel_args(template, {lvl: (coarse_img, K_lvl)}, R_b, t_b, aff0, exp_ref, exp_new,
                     aff_ref, cfg, lvl + 1, lvl, n_hyp=N)
    a.score_iters = n_iters
    scores = torch.empty(N, dtype=torch.float32, device=dev)
    a.out = scores.data_ptr()
    _launch(_kernels()[0], a, dev)
    return scores


def _route(x) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor); raises for any other device."""
    global plain_calls
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"no tracker route for device {x.device}")
    with _count_lock:
        plain_calls += 1
    return False


def track_coarse(template: Template, target_pyr: List[torch.Tensor],
                 K_pyr: torch.Tensor, R0, t0, aff0, exp_ref, exp_new, aff_ref,
                 cfg: Config, coarsest_lvl: Optional[int] = None,
                 min_res_for_abort: Optional[torch.Tensor] = None,
                 packed_pyr: Optional[List[torch.Tensor]] = None) -> TrackResult:
    """Coarse-to-fine LM alignment of one motion hypothesis
    (trackNewestCoarse): cutoff doubling, per-level iteration caps, lambda
    schedule, extrapolation, early abort and the affine sanity check. CUDA
    tensors: one kernel launch and no host read (`packed_pyr` is not used);
    CPU tensors: the plain version."""
    if _route(R0):
        return track_coarse_kernel(template, target_pyr, K_pyr, R0, t0, aff0, exp_ref,
                                   exp_new, aff_ref, cfg, coarsest_lvl, min_res_for_abort)
    return track_coarse_plain(template, target_pyr, K_pyr, R0, t0, aff0, exp_ref, exp_new,
                              aff_ref, cfg, coarsest_lvl, min_res_for_abort, packed_pyr)


def score_hypotheses(template: Template, coarse_img: torch.Tensor, K_lvl,
                     lvl: int, R_b, t_b, aff0, exp_ref, exp_new, aff_ref,
                     cfg: Config, n_iters: int = SCORE_ITERS,
                     packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed-iteration GN of all N hypotheses at the coarsest level. Returns
    (N,) mean energy E/n, inf for diverged hypotheses. CUDA tensors: one
    kernel launch (`packed` is not used); CPU tensors: the plain version."""
    trace.count("hyp_scored", R_b.shape[0])
    if _route(R_b):
        return score_hypotheses_kernel(template, coarse_img, K_lvl, lvl, R_b, t_b, aff0,
                                       exp_ref, exp_new, aff_ref, cfg, n_iters)
    return score_hypotheses_plain(template, coarse_img, K_lvl, lvl, R_b, t_b, aff0, exp_ref,
                                  exp_new, aff_ref, cfg, n_iters, packed)


def track_coarse_multi(template: Template, target_pyr: List[torch.Tensor],
                       K_pyr, R_b, t_b, aff0, exp_ref, exp_new, aff_ref,
                       cfg: Config, coarsest_lvl: Optional[int] = None,
                       min_res_for_abort=None) -> Tuple[TrackResult, torch.Tensor]:
    """Score every hypothesis at the coarsest level, then run the full
    coarse-to-fine LM on the argmin. Returns (result, best_idx). The argmin
    picks the start on the device: no host read."""
    n_levels = len(target_pyr)
    if coarsest_lvl is None:
        coarsest_lvl = n_levels - 1
    R_b, t_b = R_b.contiguous(), t_b.contiguous()
    packed_pyr = (None if R_b.device.type == "cuda"
                  else [pack_pyramid_level(t) for t in target_pyr])
    with trace.span("track.score"):
        scores = score_hypotheses(
            template, target_pyr[coarsest_lvl], K_pyr[coarsest_lvl], coarsest_lvl,
            R_b, t_b, aff0, exp_ref, exp_new, aff_ref, cfg,
            packed=None if packed_pyr is None else packed_pyr[coarsest_lvl])
        best = torch.argmin(scores)
        pick = best.reshape(1)
    res = track_coarse(template, target_pyr, K_pyr, R_b.index_select(0, pick)[0],
                       t_b.index_select(0, pick)[0], aff0, exp_ref, exp_new, aff_ref, cfg,
                       coarsest_lvl=coarsest_lvl, min_res_for_abort=min_res_for_abort,
                       packed_pyr=packed_pyr)
    return res._replace(ok=res.ok & torch.isfinite(scores.index_select(0, pick)[0])), best


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
    lm: Optional[torch.Tensor] = None   # TrackResult.lm


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
                        residuals=res.residuals, flow=res.flow, c2w=c2w, lm=res.lm)
