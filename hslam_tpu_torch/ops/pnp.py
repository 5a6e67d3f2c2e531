"""Batched PnP RANSAC + Gauss-Newton refinement (port of
hslam_tpu/ops/pnp.py), used by relocalization.

Minimal 6-point DLT samples are solved as one batch (batched SVD), scored
by reprojection inliers together with an optional prior pose, and the best
hypothesis is refined by two rounds of robust SE3 GN. The DLT pose is
invariant to the sign of the singular vectors, so the two libraries' SVD
conventions do not matter where the sample determines a pose.

Where it does not (coplanar points, a point drawn twice), the 12x12 system
has a null space of more than one dimension and the "smallest" singular
vector is whatever the SVD routine returns: XLA's gives the same benign
pose for every sample, LAPACK's and cuSOLVER's an arbitrary one per sample,
and a few accidental inliers then beat a prior that drift has left with
none. So that the outcome does not hang on that, a prior pose that lost the
scoring is refined as well, and the refinement that ends with more inliers
is the result (the scoring's winner on a tie, as in the JAX package).

RANSAC samples (C3): the JAX package draws them with jax.random.choice
(pnp.py:85); `samples` lets a test pass those in, otherwise they come from
a torch.Generator seeded with `seed`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import lie, trace


class PnPResult(NamedTuple):
    ok: torch.Tensor        # ()
    R: torch.Tensor         # (3, 3) world-to-cam
    t: torch.Tensor         # (3,)
    inliers: torch.Tensor   # (N,)


def _dlt_pose(X, x_n):
    """X (B, 6, 3) world points, x_n (B, 6, 2) normalized image coordinates
    -> (R (B, 3, 3), t (B, 3)) world-to-cam by DLT + orthogonalization."""
    B, n = X.shape[0], X.shape[1]
    zeros = torch.zeros((B, n, 4), device=X.device)
    Xh = torch.cat([X, torch.ones((B, n, 1), device=X.device)], -1)
    r1 = torch.cat([Xh, zeros, -x_n[..., 0:1] * Xh], -1)
    r2 = torch.cat([zeros, Xh, -x_n[..., 1:2] * Xh], -1)
    A = torch.cat([r1, r2], 1)                                   # (B, 12, 12)
    _, _, Vh = torch.linalg.svd(A)
    P = Vh[:, -1].reshape(B, 3, 4)
    U, S, Vh2 = torch.linalg.svd(P[:, :, :3])
    sgn = torch.sign(torch.linalg.det(U @ Vh2))
    R = U @ Vh2 * sgn[:, None, None]
    scale = sgn * S.mean(-1)
    scale = torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12), scale)
    t = P[:, :, 3] / scale[:, None]
    # cheirality on the sample centroid: flip if behind
    zc = (R @ X.mean(1)[..., None])[:, 2, 0] + t[:, 2]
    flip = (zc < 0)[:, None]
    return torch.where(flip[..., None], -R, R), torch.where(flip, -t, t)


def _reproj_err(R, t, X, x_px, K):
    """Pixel reprojection error of every point under every pose (B, N);
    1e9 for points behind the camera."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.where(Xc[..., 2].abs() < 1e-9, torch.full_like(Xc[..., 2], 1e-9), Xc[..., 2])
    u = K[0, 0] * Xc[..., 0] / z + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / z + K[1, 2]
    err = torch.sqrt((u - x_px[:, 0]) ** 2 + (v - x_px[:, 1]) ** 2)
    return torch.where(Xc[..., 2] > 0.01, err, torch.full_like(err, 1e9))


def pnp_samples(valid: torch.Tensor, n_iters: int, seed: int) -> torch.Tensor:
    """(n_iters, 6) point indices drawn with replacement among valid ones."""
    probs = valid.float()
    probs = torch.where(probs.sum() > 0, probs, torch.ones_like(probs))
    g = torch.Generator(device=valid.device)
    g.manual_seed(int(seed))
    return torch.multinomial(probs, n_iters * 6, replacement=True,
                             generator=g).reshape(n_iters, 6)


def _gn_round(R, t, X, x_px, valid, K, basin_px, n_steps, hard_mask=None):
    """`n_steps` robust SE3 GN steps (left-multiplied increments) with the
    IRLS basin `basin_px`."""
    fx, fy = K[0, 0], K[1, 1]
    for _ in range(n_steps):
        Xc = X @ R.T + t
        z = torch.where(Xc[:, 2].abs() < 1e-9, torch.full_like(Xc[:, 2], 1e-9), Xc[:, 2])
        u = Xc[:, 0] / z
        v = Xc[:, 1] / z
        ru = fx * u + K[0, 2] - x_px[:, 0]
        rv = fy * v + K[1, 2] - x_px[:, 1]
        err = torch.sqrt(ru * ru + rv * rv)
        hw = torch.where(err < basin_px, torch.ones_like(err),
                         basin_px / torch.clamp(err, min=1e-9))
        w = valid.float() * hw * (Xc[:, 2] > 0.01).float()
        if hard_mask is not None:
            w = w * hard_mask
        iz = 1.0 / z
        zr = torch.zeros_like(iz)
        Ju = torch.stack([fx * iz, zr, -fx * u * iz, -fx * u * v, fx * (1 + u * u), -fx * v], -1)
        Jv = torch.stack([zr, fy * iz, -fy * v * iz, -fy * (1 + v * v), fy * u * v, fy * u], -1)
        J = torch.cat([Ju * w[:, None], Jv * w[:, None]], 0)       # (2N, 6)
        r = torch.cat([ru * w, rv * w])
        H = J.T @ J + torch.eye(6, device=X.device) * 1e-4
        dx, _ = torch.linalg.solve_ex(H, (J.T @ r)[:, None])
        dR, dt = lie.se3_exp(-dx[:, 0])
        R, t = lie.se3_mul(dR, dt, R, t)
    return R, t


def solve_pnp(X, x_px, valid, K, seed: int = 0, n_iters: int = 64,
              inlier_px: float = 3.0, min_inliers: int = 12,
              init_R: Optional[torch.Tensor] = None,
              init_t: Optional[torch.Tensor] = None,
              samples: Optional[torch.Tensor] = None) -> PnPResult:
    """X (N, 3) world points, x_px (N, 2) pixels, valid (N,), K (3, 3).
    init_R/init_t: a prior pose scored beside the DLT samples (the DLT is
    degenerate on planar scenes)."""
    N = X.shape[0]
    Kinv = torch.linalg.inv(K)
    x_n = (torch.cat([x_px, torch.ones((N, 1), device=X.device)], -1) @ Kinv.T)[:, :2]
    if samples is None:
        samples = pnp_samples(valid, n_iters, seed)
    Rs, ts = _dlt_pose(X[samples], x_n[samples])
    if init_R is not None:
        Rs = torch.cat([Rs, init_R[None]], 0)
        ts = torch.cat([ts, init_t[None]], 0)
    errs = _reproj_err(Rs, ts, X, x_px, K)
    inl = (errs < inlier_px) & valid[None, :]

    def refine(R, t):
        """A wide IRLS basin first, so that an approximate hypothesis pulls
        in, then the hard inliers."""
        R, t = _gn_round(R, t, X, x_px, valid, K, 3.0 * inlier_px, 6)
        hard = ((_reproj_err(R, t, X, x_px, K) < inlier_px) & valid).float()
        R, t = _gn_round(R, t, X, x_px, valid, K, inlier_px, 5, hard)
        return R, t, (_reproj_err(R, t, X, x_px, K) < inlier_px) & valid

    best = inl.sum(-1).argmax()
    trace.count("host_sync", 2)        # indexing by the device scalar `best` reads it
    R, t, inliers = refine(Rs[best], ts[best])
    if init_R is not None:
        Rp, tp, inl_p = refine(init_R, init_t)
        prior_wins = inl_p.sum() > inliers.sum()
        R, t = torch.where(prior_wins, Rp, R), torch.where(prior_wins, tp, t)
        inliers = torch.where(prior_wins, inl_p, inliers)
    return PnPResult(ok=inliers.sum() >= min_inliers, R=R, t=t, inliers=inliers)
