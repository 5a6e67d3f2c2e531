"""Keyframe-block-sharded global bundle adjustment (port of
hslam_tpu/parallel/global_ba.py).

A full metric BA over hundreds of keyframes with their landmark depths:

  * State: world-to-cam SE3 poses (N, ...) and one inverse depth per
    landmark (P,) in its host keyframe, Schur-eliminated like the window
    BA's inverse depths.
  * Measurements: pixel reprojections of a landmark into other keyframes,
    Huber-robust, with a hard gate on gross outliers.
  * Solve: Gauss-Newton; the reduced camera system (6N x 6N after the
    per-point Schur) is applied matrix-free inside PCG, each product two
    sums over observations into poses plus a per-point scalar pass, with a
    block-Jacobi (6x6) preconditioner. No O(N^2) memory.
  * Sums over observations have a fixed order (utils/segsum.SortedBins,
    sorted once per GN step), so a run gives the same bits every time.
  * Sharding: landmarks live with their host keyframe; a contiguous block
    of landmarks (and all their observations) goes to each rank
    (`partition_problem`). The (N, 6) sums are summed over the mesh each CG
    iteration; the per-point algebra needs no communication.
  * Gauge: pose 0 pinned (6 dofs) and a soft inverse-depth prior (scale).

Entry points: `build_problem`, `global_ba` (one rank), `partition_problem`,
`sharded_global_ba` (the same math over a mesh) and
`build_problem_from_trajectory` (a synthetic problem, numpy).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import lie
from ..utils.segsum import SortedBins
from .distributed import Mesh, all_gather, psum


class GlobalBA(NamedTuple):
    # keyframe states (world-to-cam), replicated across ranks
    R: torch.Tensor        # (N, 3, 3)
    t: torch.Tensor        # (N, 3)
    # landmarks, sharded by host-keyframe block
    host: torch.Tensor     # (P,) int64 host keyframe index
    pu: torch.Tensor       # (P,) pixel in the host frame
    pv: torch.Tensor       # (P,)
    rho: torch.Tensor      # (P,) inverse depth in the host frame
    p_valid: torch.Tensor  # (P,) bool
    # observations of a landmark in a target keyframe, sharded with their
    # landmark (obs_p indexes the rank's landmark block)
    obs_p: torch.Tensor    # (O,) int64 landmark index
    obs_t: torch.Tensor    # (O,) int64 target keyframe index
    obs_uv: torch.Tensor   # (O, 2) measured pixel
    obs_w: torch.Tensor    # (O,) weight; 0 disables


def _as(x, dtype, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


def build_problem(R, t, host, pu, pv, rho, obs_p, obs_t, obs_uv,
                  obs_w=None, p_valid=None, device="cuda") -> GlobalBA:
    """Pack numpy arrays or tensors into a GlobalBA on `device`."""
    f32, i64 = torch.float32, torch.int64
    obs_p = _as(obs_p, i64, device)
    host = _as(host, i64, device)
    if obs_w is None:
        obs_w = torch.ones(obs_p.shape[0])
    if p_valid is None:
        p_valid = torch.ones(host.shape[0], dtype=torch.bool)
    return GlobalBA(
        R=_as(R, f32, device), t=_as(t, f32, device), host=host,
        pu=_as(pu, f32, device), pv=_as(pv, f32, device), rho=_as(rho, f32, device),
        p_valid=_as(p_valid, torch.bool, device), obs_p=obs_p,
        obs_t=_as(obs_t, i64, device), obs_uv=_as(obs_uv, f32, device),
        obs_w=_as(obs_w, f32, device))


def _project(Rw, tw, Xw, K):
    """World point -> pixel + depth in a w2c frame."""
    Xc = torch.einsum("oij,oj->oi", Rw, Xw) + tw
    z = torch.where(Xc[:, 2].abs() < 1e-9, 1e-9, Xc[:, 2])
    u = K[0, 0] * Xc[:, 0] / z + K[0, 2]
    v = K[1, 1] * Xc[:, 1] / z + K[1, 2]
    return torch.stack([u, v], -1), Xc


def _linearize(p: GlobalBA, K):
    """Per-observation residual (O, 2) and Jacobians with respect to the
    host pose (O, 2, 6), the target pose (O, 2, 6) [left se3 increments on
    world-to-cam] and the host inverse depth (O, 2). Host-frame
    back-projection: X_h = d Kinv [u, v, 1], d = 1/rho; X_w = R_h^T (X_h - t_h)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    h = p.host[p.obs_p]
    tg = p.obs_t
    d = 1.0 / torch.clamp(p.rho[p.obs_p], min=1e-6)
    xh = (p.pu[p.obs_p] - cx) / fx
    yh = (p.pv[p.obs_p] - cy) / fy
    X_h = torch.stack([xh * d, yh * d, d], -1)
    Rh, th = p.R[h], p.t[h]
    Rt, tt = p.R[tg], p.t[tg]
    X_w = torch.einsum("oji,oj->oi", Rh, X_h - th)
    uv, Xc = _project(Rt, tt, X_w, K)
    r = uv - p.obs_uv

    # d pixel / d X_c (target camera coordinates)
    z = torch.where(Xc[:, 2].abs() < 1e-9, 1e-9, Xc[:, 2])
    iz = 1.0 / z
    u_n, v_n = Xc[:, 0] * iz, Xc[:, 1] * iz
    zero = torch.zeros_like(iz)
    Jpi = torch.stack([
        torch.stack([fx * iz, zero, -fx * u_n * iz], -1),
        torch.stack([zero, fy * iz, -fy * v_n * iz], -1),
    ], -2)                                                 # (O, 2, 3)

    # target pose, left increment xi: d X_c / d xi = [I | -[X_c]_x]
    J_t = torch.cat([Jpi, -Jpi @ lie.hat(Xc)], dim=-1)     # (O, 2, 6)

    # host pose: X_w = R_h^T (X_h - t_h), chained through R_t
    RtRhT = Rt @ Rh.transpose(1, 2)
    J_h = torch.cat([Jpi @ -RtRhT, Jpi @ (RtRhT @ lie.hat(X_h))], dim=-1)

    # inverse depth: X_h = bearing / rho => dX_h/drho = -X_h / rho
    rho = torch.clamp(p.rho[p.obs_p], min=1e-6)
    dXw_drho = torch.einsum("oji,oj->oi", Rh, -X_h / rho[:, None])
    dXc_drho = torch.einsum("oij,oj->oi", Rt, dXw_drho)
    J_rho = torch.einsum("oab,ob->oa", Jpi, dXc_drho)      # (O, 2)
    return r, J_h, J_t, J_rho


def _huber_w(r, k):
    """IRLS weights for a Huber loss with threshold k (px)."""
    e = torch.linalg.norm(r, dim=-1)
    return torch.where(e <= k, 1.0, k / torch.clamp(e, min=1e-12))


def gn_step(p: GlobalBA, K, cg_iters: int = 100, huber_px: float = 3.0,
            rho_prior: float = 1.0, damping: float = 1e-4,
            outlier_px: float = 20.0, axis: Mesh | None = None):
    """One Gauss-Newton step: linearize, Schur-eliminate inverse depths,
    matrix-free PCG on the reduced (N*6) camera system, back-substitute.
    Returns (new problem, chi2 before the step). Under `axis` the landmark
    and observation arrays are this rank's block and the (N, 6) sums are
    summed over the mesh."""
    N = p.R.shape[0]
    P_ = p.host.shape[0]

    r, J_h, J_t, J_rho = _linearize(p, K)
    h = p.host[p.obs_p]
    tg = p.obs_t
    valid = (p.obs_w > 0) & p.p_valid[p.obs_p]
    # Huber reweighting, and a hard gate on gross outliers
    e = torch.linalg.norm(r, dim=-1)
    w = torch.where(valid & (e <= outlier_px), p.obs_w * _huber_w(r, huber_px), 0.0)
    chi2 = psum(torch.sum(w * torch.sum(r * r, -1)), axis)

    # gauge: pin pose 0 by zeroing its Jacobian columns
    J_h = J_h * (h != 0).to(J_h.dtype)[:, None, None]
    J_t = J_t * (tg != 0).to(J_t.dtype)[:, None, None]
    wr = w[:, None] * r

    # sums into landmarks and into poses (host entries, then target ones)
    by_point = SortedBins(p.obs_p, P_)
    by_pose = SortedBins(torch.cat([h, tg]), N)

    def scat_c(vh, vt):
        """(O, ...) contributions of the host and the target pose -> (N, ...)."""
        return by_pose(torch.cat([vh, vt]))

    # per-point Schur scalars: Hdd = sum w |J_rho|^2 + prior, bd = sum w J_rho.r
    Hdd = by_point(torch.sum(w[:, None] * J_rho * J_rho, -1)) + rho_prior
    bd = by_point(torch.sum(J_rho * wr, -1))
    iHdd = 1.0 / Hdd

    def Jt_v(J, v):
        return torch.einsum("oab,oa->ob", J, v)

    b_c = scat_c(Jt_v(J_h, wr), Jt_v(J_t, wr))
    # camera-depth coupling per observation, E = J_c^T w J_rho (6,)
    E_h = Jt_v(J_h, w[:, None] * J_rho)
    E_t = Jt_v(J_t, w[:, None] * J_rho)
    # reduced gradient b = b_c - E iHdd bd
    s_p = (iHdd * bd)[p.obs_p]
    b_red = psum(b_c - scat_c(E_h * s_p[:, None], E_t * s_p[:, None]), axis)

    # block-Jacobi preconditioner from the diagonal blocks of H_cc
    Ph = torch.einsum("oab,oac->obc", J_h * w[:, None, None], J_h)
    Pt = torch.einsum("oab,oac->obc", J_t * w[:, None, None], J_t)
    Pn = psum(scat_c(Ph, Pt), axis)
    Pn = Pn + (damping + 1e-6) * torch.eye(6, dtype=Pn.dtype, device=Pn.device)[None]
    Pn_inv = torch.linalg.inv(Pn)

    def Sx(x):
        """Reduced-system product S x = H_cc x - E iHdd E^T x + damping x.
        Each rank owns whole landmarks (partition_problem), so the
        per-point scalars stay local; only the (N, 6) sums are summed."""
        xh, xt = x[h], x[tg]
        Jx = (torch.einsum("oab,ob->oa", J_h, xh) + torch.einsum("oab,ob->oa", J_t, xt))
        wJx = w[:, None] * Jx
        etx = by_point(torch.sum(E_h * xh, -1) + torch.sum(E_t * xt, -1))
        sp = (iHdd * etx)[p.obs_p]
        hcc, schur = psum((scat_c(Jt_v(J_h, wJx), Jt_v(J_t, wJx)),
                           scat_c(E_h * sp[:, None], E_t * sp[:, None])), axis)
        return hcc - schur + damping * x

    def psolve(v):
        return torch.einsum("nab,nb->na", Pn_inv, v)

    # PCG on S dx = b_red; the stopping test reads the replicated residual
    x = torch.zeros((N, 6), dtype=b_red.dtype, device=b_red.device)
    rr = b_red
    z = psolve(rr)
    d = z
    rz = torch.sum(rr * z)
    k = 0
    while k < cg_iters and float(torch.sum(rr * rr)) > 1e-16:     # host sync
        Sd = Sx(d)
        alpha = rz / torch.clamp(torch.sum(d * Sd), min=1e-20)
        x = x + alpha * d
        rr = rr - alpha * Sd
        z = psolve(rr)
        rz_new = torch.sum(rr * z)
        d = z + (rz_new / torch.clamp(rz, min=1e-20)) * d
        rz = rz_new
        k += 1
    dx = torch.where(torch.isfinite(x), x, 0.0)
    dx[0] = 0.0                                            # gauge: pose 0

    # back-substitute inverse depths: d_rho = iHdd (bd - E^T dx)
    etx = by_point(torch.sum(E_h * dx[h], -1) + torch.sum(E_t * dx[tg], -1))
    d_rho = iHdd * (bd - etx)
    d_rho = torch.where(torch.isfinite(d_rho) & p.p_valid, d_rho, 0.0)

    # left-multiply the pose increments exp(-dx) (GN solves J dx = r with
    # r = pred - meas, so the step is the negative)
    dR, dt = lie.se3_exp(-dx)
    R_new = dR @ p.R
    t_new = torch.einsum("nab,nb->na", dR, p.t) + dt
    rho_new = torch.clamp(p.rho - d_rho, 1e-4, 1e4)
    rho_new = torch.where(p.p_valid, rho_new, p.rho)
    return p._replace(R=R_new, t=t_new, rho=rho_new), chi2


def global_ba(p: GlobalBA, K, n_iters: int = 5, cg_iters: int = 100,
              huber_px: float = 3.0, rho_prior: float = 1.0,
              axis: Mesh | None = None):
    """GN relaxation; returns (problem, chi2 history (n_iters,))."""
    K = _as(K, torch.float32, p.R.device)
    chis = []
    for _ in range(n_iters):
        p, chi2 = gn_step(p, K, cg_iters=cg_iters, huber_px=huber_px,
                          rho_prior=rho_prior, axis=axis)
        chis.append(chi2)
    return p, torch.stack(chis)


def partition_problem(p: GlobalBA, n_shards: int) -> GlobalBA:
    """Lay the problem out for `sharded_global_ba`: equal-sized contiguous
    landmark blocks (landmarks ordered by host keyframe, so a block spans a
    contiguous keyframe range), and equal-sized observation blocks, block s
    holding exactly the observations of landmark block s. A landmark's
    observations never cross a block boundary. Pads with invalid landmarks
    and zero-weight observations. Host-side (numpy)."""
    dev = p.R.device
    host = p.host.cpu().numpy()
    obs_p = p.obs_p.cpu().numpy()
    order = np.argsort(host, kind="stable")        # landmarks by host keyframe
    P_ = len(host)
    m = -(-P_ // n_shards)                         # landmarks per block

    def take_p(a, idx, pad, padval):
        a = a.cpu().numpy()[idx]
        if pad:
            a = np.concatenate([a, np.full((pad,) + a.shape[1:], padval, a.dtype)])
        return a

    pad_p = m * n_shards - P_
    new_host = take_p(p.host, order, pad_p, 0)
    inv = np.empty(P_, np.int64)
    inv[order] = np.arange(P_)                     # old id -> new id

    # group observations by new landmark id, then block them
    new_obs_p = inv[obs_p]
    oorder = np.argsort(new_obs_p, kind="stable")
    counts = np.bincount(new_obs_p[oorder] // m, minlength=n_shards)
    ob = max(int(counts.max()) if len(counts) else 1, 1)
    O_new = ob * n_shards
    oidx = np.zeros(O_new, np.int64)               # indices into the observations
    ow_new = np.zeros(O_new, np.float32)
    op_new = np.zeros(O_new, np.int64)
    start = 0
    obs_w = p.obs_w.cpu().numpy()
    for s in range(n_shards):
        c = counts[s] if s < len(counts) else 0
        sel = oorder[start:start + c]
        start += c
        oidx[s * ob: s * ob + c] = sel
        ow_new[s * ob: s * ob + c] = obs_w[sel]
        op_new[s * ob: s * ob + c] = new_obs_p[sel]
        op_new[s * ob + c: (s + 1) * ob] = s * m   # padding -> the block's first landmark

    return build_problem(
        p.R, p.t, new_host, take_p(p.pu, order, pad_p, 0.0), take_p(p.pv, order, pad_p, 0.0),
        take_p(p.rho, order, pad_p, 1.0), op_new, p.obs_t.cpu().numpy()[oidx],
        p.obs_uv.cpu().numpy()[oidx], obs_w=ow_new,
        p_valid=take_p(p.p_valid, order, pad_p, False), device=dev)


def sharded_global_ba(mesh: Mesh, p: GlobalBA, K, n_iters: int = 5,
                      cg_iters: int = 100, huber_px: float = 3.0,
                      rho_prior: float = 1.0):
    """global_ba with the landmarks and observations sharded over the mesh
    (poses replicated, the (N, 6) sums summed over it every CG iteration).
    The problem must be laid out by `partition_problem(p, mesh.size)`
    first. Returns (problem, chi2 history), replicated, `rho` gathered."""
    blk_p = mesh.block(p.host.shape[0])
    blk_o = mesh.block(p.obs_p.shape[0])
    local = p._replace(
        host=p.host[blk_p], pu=p.pu[blk_p], pv=p.pv[blk_p], rho=p.rho[blk_p],
        p_valid=p.p_valid[blk_p], obs_p=p.obs_p[blk_o] - blk_p.start,
        obs_t=p.obs_t[blk_o], obs_uv=p.obs_uv[blk_o], obs_w=p.obs_w[blk_o])
    out, chis = global_ba(local, K, n_iters=n_iters, cg_iters=cg_iters,
                          huber_px=huber_px, rho_prior=rho_prior, axis=mesh)
    return p._replace(R=out.R, t=out.t, rho=all_gather(out.rho, mesh)), chis


def build_problem_from_trajectory(R_w2c, t_w2c, K, points_per_kf,
                                  obs_radius, width, height, rng,
                                  depth_fn, pix_noise=0.5, device="cuda"):
    """Synthesize a GlobalBA problem from a keyframe trajectory: sample
    `points_per_kf` pixels per keyframe, lift them with `depth_fn(u, v, i)`
    (true scene depth in the host frame), and observe each landmark in the
    keyframes within +-obs_radius that see it. Landmarks are ordered by host
    keyframe and observations by landmark. Host-side (numpy); the same
    draws from `rng` as the JAX package's function."""
    N = len(R_w2c)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    host, pu, pv, rho = [], [], [], []
    obs_p, obs_t, obs_uv = [], [], []
    pid = 0
    for i in range(N):
        us = rng.uniform(8, width - 8, points_per_kf)
        vs = rng.uniform(8, height - 8, points_per_kf)
        for u, v in zip(us, vs):
            d = depth_fn(u, v, i)
            X_h = np.array([(u - cx) / fx * d, (v - cy) / fy * d, d])
            X_w = R_w2c[i].T @ (X_h - t_w2c[i])
            seen = []
            for j in range(max(0, i - obs_radius), min(N, i + obs_radius + 1)):
                if j == i:
                    continue
                Xc = R_w2c[j] @ X_w + t_w2c[j]
                if Xc[2] < 0.2:
                    continue
                uu = fx * Xc[0] / Xc[2] + cx
                vv = fy * Xc[1] / Xc[2] + cy
                if 2 < uu < width - 3 and 2 < vv < height - 3:
                    seen.append((j, uu + rng.normal(0, pix_noise),
                                 vv + rng.normal(0, pix_noise)))
            if len(seen) >= 2:
                host.append(i)
                pu.append(u)
                pv.append(v)
                rho.append(1.0 / d)
                for (j, uu, vv) in seen:
                    obs_p.append(pid)
                    obs_t.append(j)
                    obs_uv.append((uu, vv))
                pid += 1
    return build_problem(
        np.stack(R_w2c), np.stack(t_w2c), np.array(host), np.array(pu),
        np.array(pv), np.array(rho), np.array(obs_p), np.array(obs_t),
        np.array(obs_uv), device=device)
