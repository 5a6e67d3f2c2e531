"""Two-view geometry: batched H/F RANSAC, model selection, motion recovery
and cheirality-checked triangulation (port of hslam_tpu/ops/twoview.py).

The JAX `vmap`s over RANSAC hypotheses (twoview.py:200-209), over motion
candidates (:328) and over points in the triangulation are batch
dimensions here, each a batched torch.linalg.svd. Singular-vector signs
differ between libraries; every quantity taken from them (F and H up to
scale, the motion set, inlier masks) is sign-invariant.

RANSAC samples (C3): the JAX package draws them with jax.random.choice
(:195); `samples` lets a test pass those in, otherwise they come from a
torch.Generator seeded with `seed`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import trace

CHI2_F = 3.841
CHI2_H = 5.991
SCORE_TH = 5.991
SIGMA = 1.0


def _normalize(pts):
    mean = pts.mean(0)
    d = (pts - mean).abs().mean(0)
    s = 1.0 / torch.clamp(d, min=1e-8)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (pts - mean) * s, T


def _rows_F(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _rows_H(p1, p2):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def _null_vec(A):
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    return Vh[..., -1, :].reshape(A.shape[:-2] + (3, 3))


def _rank2(F):
    U, S, Vh = torch.linalg.svd(F)
    S = torch.stack([S[..., 0], S[..., 1], torch.zeros_like(S[..., 2])], -1)
    return U @ torch.diag_embed(S) @ Vh


def _hom(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _score_F(F, p1, p2, valid):
    """F (..., 3, 3) -> (score (...), inliers (..., N))."""
    x1, x2 = _hom(p1), _hom(p2)
    Fx1 = x1 @ F.transpose(-1, -2)
    Ftx2 = x2 @ F
    num = (x2 * Fx1).sum(-1)
    d2_2 = num ** 2 / torch.clamp(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2, min=1e-12)
    d2_1 = num ** 2 / torch.clamp(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2, min=1e-12)
    chi1 = d2_1 / (SIGMA * SIGMA)
    chi2 = d2_2 / (SIGMA * SIGMA)
    in1 = (chi1 <= CHI2_F) & valid
    in2 = (chi2 <= CHI2_F) & valid
    z = torch.zeros_like(chi1)
    score = (torch.where(in1, SCORE_TH - chi1, z).sum(-1)
             + torch.where(in2, SCORE_TH - chi2, z).sum(-1))
    return score, in1 & in2


def _dehom(x):
    w = x[..., 2:3]
    return x[..., :2] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)


def _score_H(Hm, p1, p2, valid):
    Hinv, _ = torch.linalg.inv_ex(Hm)
    x1, x2 = _hom(p1), _hom(p2)
    Hx1 = _dehom(x1 @ Hm.transpose(-1, -2))
    Hix2 = _dehom(x2 @ Hinv.transpose(-1, -2))
    chi2_2 = ((p2 - Hx1) ** 2).sum(-1) / (SIGMA * SIGMA)
    chi2_1 = ((p1 - Hix2) ** 2).sum(-1) / (SIGMA * SIGMA)
    in1 = (chi2_1 <= CHI2_H) & valid
    in2 = (chi2_2 <= CHI2_H) & valid
    z = torch.zeros_like(chi2_1)
    score = (torch.where(in1, SCORE_TH - chi2_1, z).sum(-1)
             + torch.where(in2, SCORE_TH - chi2_2, z).sum(-1))
    return score, in1 & in2


class TwoViewResult(NamedTuple):
    ok: torch.Tensor
    R: torch.Tensor          # (3, 3) frame1 -> frame2
    t: torch.Tensor          # (3,) unit
    is_H: torch.Tensor
    inliers: torch.Tensor    # (N,)
    points3d: torch.Tensor   # (N, 3) frame-1 coords
    tri_ok: torch.Tensor     # (N,)


def _triangulate(R, t, K, p1, p2):
    """Linear triangulation for M motions at once. R (M, 3, 3), t (M, 3)
    -> (M, N, 3) points in frame-1 coords."""
    Kinv = torch.linalg.inv(K)
    a1 = _hom(p1) @ Kinv.T                         # (N, 3)
    a2 = _hom(p2) @ Kinv.T
    M, N = R.shape[0], p1.shape[0]
    P2 = torch.cat([R, t[..., None]], -1)          # (M, 3, 4)
    e = torch.eye(4, device=R.device)
    row0 = a1[:, 0, None] * e[2] - e[0]            # (N, 4)
    row1 = a1[:, 1, None] * e[2] - e[1]
    row2 = a2[None, :, 0, None] * P2[:, None, 2] - P2[:, None, 0]   # (M, N, 4)
    row3 = a2[None, :, 1, None] * P2[:, None, 2] - P2[:, None, 1]
    A = torch.stack([row0.expand(M, N, 4), row1.expand(M, N, 4), row2, row3], dim=-2)
    _, _, Vh = torch.linalg.svd(A)
    X = Vh[..., -1, :]
    w = X[..., 3:4]
    return X[..., :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)


def _cheirality(R, t, K, p1, p2, inliers):
    """(good (M, N), X (M, N, 3)): positive depth in both views, reprojection
    error and parallax gates (CheckRT)."""
    X = _triangulate(R, t, K, p1, p2)
    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[:, None, :]
    z2 = X2[..., 2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def safe(z):
        return torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)

    r1 = torch.stack([fx * X[..., 0] / safe(z1) + cx, fy * X[..., 1] / safe(z1) + cy], -1)
    r2 = torch.stack([fx * X2[..., 0] / safe(z2) + cx, fy * X2[..., 1] / safe(z2) + cy], -1)
    e1 = ((r1 - p1) ** 2).sum(-1)
    e2 = ((r2 - p2) ** 2).sum(-1)
    C2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    n2 = X - C2[:, None, :]
    cos_par = (X * n2).sum(-1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(n2, dim=-1), min=1e-12)
    good = (inliers & (z1 > 0) & (z2 > 0) & (e1 < 4.0 * SIGMA ** 2)
            & (e2 < 4.0 * SIGMA ** 2) & (cos_par < 0.99998))
    return good, X


def ransac_samples(valid: torch.Tensor, n_iters: int, seed: int) -> torch.Tensor:
    """(n_iters, 8) match indices drawn with replacement among valid ones."""
    probs = valid.float()
    probs = torch.where(probs.sum() > 0, probs, torch.ones_like(probs))
    g = torch.Generator(device=valid.device)
    g.manual_seed(int(seed))
    return torch.multinomial(probs, n_iters * 8, replacement=True,
                             generator=g).reshape(n_iters, 8)


def two_view_reconstruct(p1, p2, valid, K, seed: int = 0, n_iters: int = 200,
                         samples: Optional[torch.Tensor] = None) -> TwoViewResult:
    """Batched H and F RANSAC, model selection (RH > 0.40), motion recovery
    and cheirality-checked triangulation."""
    dev = p1.device
    p1n_all, T1 = _normalize(p1)
    p2n_all, T2 = _normalize(p2)
    if samples is None:
        samples = ransac_samples(valid, n_iters, seed)
    s1 = p1n_all[samples]
    s2 = p2n_all[samples]

    F_c = _rank2(_null_vec(_rows_F(s1, s2)))
    H_c = _null_vec(_rows_H(s1, s2))
    F_c = T2.T @ F_c @ T1
    T2inv = torch.linalg.inv(T2)
    H_c = T2inv @ H_c @ T1

    score_F, inl_F = _score_F(F_c, p1, p2, valid)
    score_H, inl_H = _score_H(H_c, p1, p2, valid)
    trace.count("host_sync", 2)        # indexing by device scalars reads them
    inliers_F = inl_F[torch.argmax(score_F)]
    inliers_H = inl_H[torch.argmax(score_H)]

    # refit on the full inlier sets (masked SVD)
    mF = inliers_F.float()[:, None]
    _, _, Vh = torch.linalg.svd(_rows_F(p1n_all, p2n_all) * mF, full_matrices=False)
    F_best = T2.T @ _rank2(Vh[-1].reshape(3, 3)) @ T1
    mH = torch.cat([inliers_H, inliers_H]).float()[:, None]
    _, _, Vh = torch.linalg.svd(_rows_H(p1n_all, p2n_all) * mH, full_matrices=False)
    H_best = T2inv @ Vh[-1].reshape(3, 3) @ T1
    SF, inliers_F = _score_F(F_best, p1, p2, valid)
    SH, inliers_H = _score_H(H_best, p1, p2, valid)
    use_H = SH / torch.clamp(SH + SF, min=1e-12) > 0.40

    # 4 motions from E
    E = K.T @ F_best @ K
    U, S, Vh = torch.linalg.svd(E)
    Wm = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], device=dev)
    R1 = U @ Wm @ Vh
    R2 = U @ Wm.T @ Vh
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tE = U[:, 2] / torch.clamp(torch.linalg.norm(U[:, 2]), min=1e-12)
    F_R = torch.stack([R1, R1, R2, R2])
    F_t = torch.stack([tE, -tE, tE, -tE])

    # 8 motions from H (Faugeras decomposition)
    A = torch.linalg.inv(K) @ H_best @ K
    Ua, Sa, Vta = torch.linalg.svd(A)
    d1, d2, d3 = Sa[0], Sa[1], Sa[2]
    s_det = torch.linalg.det(Ua) * torch.linalg.det(Vta)
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1a = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    x3a = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    H_R, H_t = [], []
    for e1, e3 in ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)):
        for pos in (True, False):
            x1_, x3_ = e1 * x1a, e3 * x3a
            z = torch.zeros_like(d1)
            if pos:
                st_den = torch.clamp((d1 + d3) * d2, min=1e-12)
                sin_t, cos_t = root / st_den, (d2 * d2 + d1 * d3) / st_den
                st = e1 * e3 * sin_t
                Rp = torch.stack([torch.stack([cos_t, z, -st]),
                                  torch.stack([z, z + 1.0, z]),
                                  torch.stack([st, z, cos_t])])
                tp = (d1 - d3) * torch.stack([x1_, z, -x3_])
            else:
                den = torch.clamp((d1 - d3) * d2, min=1e-12)
                sin_t, cos_t = root / den, (d1 * d3 - d2 * d2) / den
                st = e1 * e3 * sin_t
                Rp = torch.stack([torch.stack([cos_t, z, st]),
                                  torch.stack([z, z - 1.0, z]),
                                  torch.stack([st, z, -cos_t])])
                tp = (d1 + d3) * torch.stack([x1_, z, x3_])
            t_ = Ua @ tp
            H_R.append(s_det * Ua @ Rp @ Vta)
            H_t.append(t_ / torch.clamp(torch.linalg.norm(t_), min=1e-12))
    H_R = torch.stack(H_R)
    H_t = torch.stack(H_t)
    # H_R rows alternate (pos, neg) per sign pair; the JAX layout is
    # [pos x4 | neg x4] for the where-merge below
    H_R = torch.cat([H_R[0::2], H_R[1::2]])
    H_t = torch.cat([H_t[0::2], H_t[1::2]])

    all_R = torch.where(use_H, H_R, torch.cat([F_R, F_R]))
    all_t = torch.where(use_H, H_t, torch.cat([F_t, F_t]))
    inliers = torch.where(use_H, inliers_H, inliers_F)

    goods, Xs = _cheirality(all_R, all_t, K, p1, p2, inliers)
    counts = goods.sum(-1)
    dup = (torch.arange(8, device=dev) >= 4) & ~use_H
    counts = torch.where(dup, torch.full_like(counts, -1), counts)
    best = torch.argmax(counts)
    trace.count("host_sync", 5)        # indexing by the device scalar `best` reads it
    n_best = counts[best]
    n_second = torch.sort(counts).values[-2]
    ok = ((n_best > 0.8 * torch.clamp(inliers.sum(), min=1))
          & (n_second < 0.75 * n_best) & (n_best >= 30))
    return TwoViewResult(ok=ok, R=all_R[best], t=all_t[best], is_H=use_H,
                         inliers=inliers, points3d=Xs[best], tri_ok=goods[best])
