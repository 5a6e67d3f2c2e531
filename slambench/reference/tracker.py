"""Plain reference of frame-to-keyframe direct image alignment.

The energy is the one DSO's coarse tracker states (and the program's
`track_step` minimizes): the keyframe's template points (pixel, inverse
depth, intensity) warped by the relative pose refToNew (R, t) into the new
frame's level-0 image, their intensities compared under the relative affine
brightness a * I_ref + b (from the two frames' exposures and affine
parameters), Huber weights at `huber`, residuals above `cutoff` saturated;
the cutoff doubles while over 60% of the terms saturate. Its Gauss-Newton
system uses the image's interpolated central-difference gradients, and
Levenberg-Marquardt steps are taken on [trans(3), rot(3), a, b], accepted
where the mean energy falls.

`track_coarse` runs that minimization coarse to fine, with the stated
iteration caps and stopping rule, from a given start, in the dtype asked
for (float64: the reference; bfloat16: the control). The judge starts it
where the program started and compares where both end.
"""
from __future__ import annotations

import math

import torch

PRECOND = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 10.0, 1000.0)


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi):
    """[t(3), w(3)] -> (R, t) with the left Jacobian on t."""
    v, w = xi[:3], xi[3:]
    th2 = (w * w).sum()
    th = torch.sqrt(th2)
    W = hat(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    small = th2 < 1e-10
    ths = torch.where(small, torch.ones_like(th), th)
    A = torch.where(small, 1.0 - th2 / 6, torch.sin(ths) / ths)
    B = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(ths)) / (ths * ths))
    C = torch.where(small, 1.0 / 6 - th2 / 120, (ths - torch.sin(ths)) / (ths * ths * ths))
    R = eye + A * W + B * (W @ W)
    V = eye + B * W + C * (W @ W)
    return R, V @ v


def rel_affine(exp_ref, exp_new, aff_ref, aff):
    """The brightness map a * I_ref + b from the keyframe's exposure and
    affine (a, b) to the new frame's (AffLight::fromToVecExposure)."""
    t_ref = exp_ref if float(exp_ref) != 0 else torch.ones_like(exp_ref)
    t_new = exp_new if float(exp_new) != 0 else torch.ones_like(exp_new)
    a = torch.exp(aff[0] - aff_ref[0]) * t_new / t_ref
    return a, aff[1] - a * aff_ref[1]


def warp(tpl, K, R, t):
    """Template points (u, v, idepth) through refToNew (R, t): pixel
    coordinates (Ku, Kv), normalized (x, y) and the new inverse depth."""
    u, v, idp = tpl[0], tpl[1], tpl[2]
    fx, fy, cx, cy = K
    px, py = (u - cx) / fx, (v - cy) / fy
    X = R[0, 0] * px + R[0, 1] * py + R[0, 2] + t[0] * idp
    Y = R[1, 0] * px + R[1, 1] * py + R[1, 2] + t[1] * idp
    Z = R[2, 0] * px + R[2, 1] * py + R[2, 2] + t[2] * idp
    Z = torch.where(Z.abs() < 1e-12, torch.full_like(Z, 1e-12), Z)
    x, y = X / Z, Y / Z
    return fx * x + cx, fy * y + cy, x, y, idp / Z


def system(tpl, img3, K, R, t, a, b, b0, cutoff, huber):
    """(E, n, n_saturated, H (8, 8), g (8,)) of the energy at (R, t, a, b)."""
    Hl, Wl = img3.shape[0], img3.shape[1]
    Ku, Kv, x, y, nid = warp(tpl, K, R, t)
    color, valid = tpl[3], tpl[4]
    mask = valid & (Ku > 2) & (Kv > 2) & (Ku < Wl - 3) & (Kv < Hl - 3) & (nid > 0)
    Kuc = torch.clamp(Ku, 0.0, Wl - 1.001)
    Kvc = torch.clamp(Kv, 0.0, Hl - 1.001)
    ix = torch.clamp(torch.floor(Kuc).long(), 0, Wl - 2)
    iy = torch.clamp(torch.floor(Kvc).long(), 0, Hl - 2)
    dx = (Kuc - ix.to(Kuc.dtype))[:, None]
    dy = (Kvc - iy.to(Kvc.dtype))[:, None]
    hit = ((img3[iy, ix] * (1 - dx) + img3[iy, ix + 1] * dx) * (1 - dy)
           + (img3[iy + 1, ix] * (1 - dx) + img3[iy + 1, ix + 1] * dx) * dy)
    I, gx, gy = hit[:, 0], hit[:, 1] * K[0], hit[:, 2] * K[1]
    mask = mask & torch.isfinite(I)
    r = I - (a * color + b)
    ar = r.abs()
    hw = torch.where(ar < huber, torch.ones_like(ar), huber / torch.clamp(ar, min=1e-12))
    sat = (ar > cutoff) & mask
    inl = mask & ~sat
    zero = torch.zeros_like(r)
    E = (torch.where(inl, hw * r * r * (2 - hw), zero).sum()
         + sat.to(r.dtype).sum() * (2 * huber * cutoff - huber * huber))
    J = torch.stack([nid * gx, nid * gy, -nid * (x * gx + y * gy),
                     -(x * y * gx + (1 + y * y) * gy), x * y * gy + (1 + x * x) * gx,
                     x * gy - y * gx, a * (b0 - color), -torch.ones_like(x)], -1)
    w = torch.where(inl, hw, zero)
    H = J.T @ (J * w[:, None])
    g = J.T @ (r * w)
    return E, mask.to(r.dtype).sum(), sat.to(r.dtype).sum(), H, g


def level_K(K0, lvl):
    """Intrinsics at pyramid level `lvl` of the level-0 (fx, fy, cx, cy):
    each level halves the image, pixel centres at +0.5."""
    s = 0.5 ** lvl
    return [K0[0] * s, K0[1] * s, (K0[2] + 0.5) * s - 0.5, (K0[3] + 0.5) * s - 0.5]


def track_coarse(tpl_levels, pyr, K0, exp_ref, exp_new, aff_ref, R, t, aff, tracker: dict,
                 coarsest: int, min_res=None, dtype=torch.float64):
    """Coarse-to-fine alignment from (R, t, aff), as DSO's trackNewestCoarse
    states it: on each level from `coarsest` down to 0, the cutoff doubled
    while over 60% of the terms saturate, then at most
    tracker["iters_per_level"][lvl] LM steps (lambda 0.01, halved on an
    accepted step and quadrupled, at least to 0.001, on a rejected one; the
    step extrapolated by (0.001 / lambda)^(1/4) below 0.001), stopping once
    a step's preconditioned norm is at most 1e-3. A level whose final rmse
    exceeds 1.5x `min_res` at that level aborts the rest; a level that had
    to double its cutoff runs once more. Every tensor in `dtype` (the 8x8
    solve in at least float32). Returns (R, t, aff, ok)."""
    cast = lambda x: torch.as_tensor(x).to(dtype)  # noqa: E731
    tpls = [[cast(x) if x.dtype.is_floating_point else x for x in tl] for tl in tpl_levels]
    pyr = [cast(p) for p in pyr]
    R, t, aff = cast(R), cast(t), cast(aff)
    exp_ref, exp_new, aff_ref = cast(exp_ref), cast(exp_new), cast(aff_ref)
    b0 = aff_ref[1]
    huber, base_cut = float(tracker["huber_th"]), float(tracker["coarse_cutoff_th"])
    iters = tracker["iters_per_level"]
    solve_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    precond = torch.tensor(PRECOND, dtype=solve_dtype, device=pyr[0].device)

    def run_level(lvl, R, t, aff):
        K = [cast(k) for k in level_K([float(k) for k in K0], lvl)]

        def at(R_, t_, aff_, cutoff):
            a, b = rel_affine(exp_ref, exp_new, aff_ref, aff_)
            return system(tpls[lvl], pyr[lvl], K, R_, t_, a, b, b0, cutoff, huber)

        E, n, nsat, H, g = at(R, t, aff, base_cut)
        cut = 1.0
        while float(nsat / torch.clamp(n, min=1.0)) > 0.6 and cut < 50.0:
            cut *= 2.0
            E, n, nsat, H, g = at(R, t, aff, base_cut * cut)
        cutoff = base_cut * cut
        lam = 0.01
        for _ in range(iters[min(lvl, len(iters) - 1)]):
            Hs, gs = H.to(solve_dtype), g.to(solve_dtype)
            inc, _ = torch.linalg.solve_ex(Hs + torch.diag(torch.diagonal(Hs) * lam), -gs)
            if lam < 0.001:
                inc = inc * (0.001 / lam) ** 0.25
            if not bool(torch.isfinite(inc.sum())):
                inc = torch.zeros_like(inc)
            dR, dt = se3_exp(inc[:6].to(dtype))
            R_n, t_n, aff_n = dR @ R, dR @ t + dt, aff + inc[6:].to(dtype)
            E_n, n_n, _, H_n, g_n = at(R_n, t_n, aff_n, cutoff)
            if float(E_n / torch.clamp(n_n, min=1.0)) < float(E / torch.clamp(n, min=1.0)):
                R, t, aff, E, n, H, g = R_n, t_n, aff_n, E_n, n_n, H_n, g_n
                lam *= 0.5
            else:
                lam = max(lam * 4.0, 0.001)
            if float(torch.linalg.norm(inc / precond)) <= 1e-3:
                break
        E, n, *_ = at(R, t, aff, cutoff)
        return R, t, aff, float(torch.sqrt(E / torch.clamp(n, min=1.0))), cut

    ok, repeated = True, False
    for lvl in range(coarsest, -1, -1):
        R, t, aff, rmse, cut = run_level(lvl, R, t, aff)
        lim = math.inf if min_res is None else float(min_res[min(lvl, len(min_res) - 1)])
        ok = not rmse > 1.5 * lim
        if not ok:
            break
        if cut > 1.0 and not repeated:
            repeated = True
            R, t, aff, rmse, _ = run_level(lvl, R, t, aff)
    ok = ok and abs(float(aff[0])) <= 1.2 and abs(float(aff[1])) <= 200.0
    return R, t, aff, ok


def pose_gap_px(tpl, K, R1, t1, R2, t2) -> float:
    """The largest distance, in level-0 pixels, between where the two poses
    put a valid template point that lies in front of both (inf where the
    poses differ and no point does)."""
    f64 = lambda x: torch.as_tensor(x).to(torch.float64)  # noqa: E731
    tpl = [f64(x) if x.dtype.is_floating_point else x for x in tpl]
    K = [f64(k) for k in K]
    R1, t1, R2, t2 = f64(R1), f64(t1), f64(R2), f64(t2)
    u1, v1, _, _, n1 = warp(tpl, K, R1, t1)
    u2, v2, _, _, n2 = warp(tpl, K, R2, t2)
    keep = tpl[4] & (n1 > 0) & (n2 > 0)
    if not bool(keep.any()):
        same = torch.equal(R1, R2) and torch.equal(t1, t2)
        return 0.0 if same else float("inf")
    return float(torch.hypot(u1 - u2, v1 - v2)[keep].max())


def affine_gap(exp_ref, exp_new, aff_ref, aff1, aff2) -> float:
    """The largest difference, in grey levels over intensities 0..255,
    between the two brightness maps."""
    f64 = lambda x: torch.as_tensor(x).to(torch.float64)  # noqa: E731
    a1, b1 = rel_affine(f64(exp_ref), f64(exp_new), f64(aff_ref), f64(aff1))
    a2, b2 = rel_affine(f64(exp_ref), f64(exp_new), f64(aff_ref), f64(aff2))
    return float(max(abs(b1 - b2), abs(255 * (a1 - a2) + b1 - b2)))
