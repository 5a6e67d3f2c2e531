"""Batched SO(3) / SE(3) / Sim(3) operations on torch tensors (port of
hslam_tpu/utils/lie.py).

Conventions as in the JAX package: SE3 elements are (R (..., 3, 3),
t (..., 3)); se3 tangents are [translation(3), rotation(3)]; exp is the left
matrix exponential. Sim3 elements are (s (...,), R, t) acting as
x -> s R x + t, with tangents [v(3), w(3), sigma] and s = exp(sigma).
Small-angle and small-sigma branches use torch.where over both arms with the
same Taylor fallbacks, so there is no data-dependent control flow, no
`.item()` and no in-place write: every function runs under torch.func's
forward-mode jvp, which the pose graph differentiates through at exactly
zero (forward mode takes the tangent of the selected arm only, so the dead
arm's division by zero never reaches the result).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """so3 hat operator: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _sinc_terms(theta2):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with series near zero."""
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < 1e-8
    th2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    th_safe = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(th_safe) / th_safe)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(th_safe)) / th2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (th_safe - torch.sin(th_safe)) / (th2_safe * th_safe))
    return A, B, C


def so3_exp(w):
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_terms(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R):
    """Via the quaternion: stable over the whole angle range."""
    q = rot_to_quat(R)
    xyz = q[..., :3]
    qw = q[..., 3]
    n = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(n, qw)
    small = n < 1e-6
    n_safe = torch.where(small, torch.ones_like(n), n)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=1e-6), theta / n_safe)
    return xyz * scale[..., None]


def so3_left_jacobian(w):
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_terms(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * W2


def so3_left_jacobian_inv(w):
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < 1e-8
    th_safe = torch.where(small, torch.ones_like(theta), theta)
    half = th_safe * 0.5
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / th_safe ** 2)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * W2


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def se3_exp(xi):
    """(..., 6) [t, w] -> (R, t)."""
    v, w = xi[..., :3], xi[..., 3:]
    return so3_exp(w), _mv(so3_left_jacobian(w), v)


def se3_log(R, t):
    w = so3_log(R)
    return torch.cat([_mv(so3_left_jacobian_inv(w), t), w], dim=-1)


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def se3_mul(Ra, ta, Rb, tb):
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_adjoint(R, t):
    """Ad = [[R, hat(t) R], [0, R]] for the [v, w] tangent ordering."""
    tR = hat(t) @ R
    Z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def quat_to_rot(q):
    """Unit quaternion [x, y, z, w] -> (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.clamp(n, min=_EPS), torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R):
    """Rotation matrix -> unit quaternion [x, y, z, w], w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def sq(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    qw0 = sq(1.0 + tr)
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0],
                     dim=-1) / (4.0 * qw0[..., None])
    qx1 = sq(1.0 + m00 - m11 - m22)
    q1 = torch.stack([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12],
                     dim=-1) / (4.0 * qx1[..., None])
    qy2 = sq(1.0 - m00 + m11 - m22)
    q2 = torch.stack([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20],
                     dim=-1) / (4.0 * qy2[..., None])
    qz3 = sq(1.0 - m00 - m11 + m22)
    q3 = torch.stack([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01],
                     dim=-1) / (4.0 * qz3[..., None])
    cases = torch.stack([q0, q1, q2, q3], dim=-2)             # (..., 4, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cases, -2, idx)[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Sim(3), for the scale-drift-aware pose graph
# ---------------------------------------------------------------------------


def _sim3_V(w, sigma):
    """The matrix V of the sim3 exponential (closed form, Strasdat's
    thesis): t = V v."""
    s = torch.exp(sigma)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    W = hat(w)
    W2 = W @ W
    eps = 1e-6
    sig_small = sigma.abs() < eps
    th_small = theta < eps
    sig_safe = torch.where(sig_small, torch.ones_like(sigma), sigma)
    th_safe = torch.where(th_small, torch.ones_like(theta), theta)
    A_ss = torch.where(sig_small, 1.0 + sigma / 2.0, (s - 1.0) / sig_safe)
    # exact closed forms (valid at sigma == 0 as they stand):
    #   A = [s (sigma sin t - t cos t) + t] / (t (sigma^2 + t^2))
    #   B = [A_ss - (s (sigma cos t + t sin t) - sigma) / (sigma^2 + t^2)] / t^2
    a = sigma * sigma + th_safe * th_safe
    ct, st = torch.cos(th_safe), torch.sin(th_safe)
    A_gen = (s * (sigma * st - th_safe * ct) + th_safe) / (a * th_safe)
    B_gen = (A_ss - (s * (sigma * ct + th_safe * st) - sigma) / a) / (th_safe * th_safe)
    A_thsmall = torch.where(sig_small, 0.5 + sigma / 3.0,
                            ((sig_safe - 1.0) * s + 1.0) / (sig_safe * sig_safe))
    B_thsmall = torch.where(
        sig_small, 1.0 / 6.0 + sigma / 8.0,
        (s * (0.5 * sig_safe * sig_safe - sig_safe + 1.0) - 1.0) / (sig_safe ** 3))
    A = torch.where(th_small, A_thsmall, A_gen)
    B = torch.where(th_small, B_thsmall, B_gen)
    return (A_ss[..., None, None] * _eye_like(W) + A[..., None, None] * W
            + B[..., None, None] * W2)


def sim3_exp(xi):
    """(..., 7) -> (s (...,), R (..., 3, 3), t (..., 3))."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return torch.exp(sigma), so3_exp(w), _mv(_sim3_V(w, sigma), v)


def sim3_log(s, R, t):
    """Inverse of sim3_exp: solves V v = t with the same V."""
    w = so3_log(R)
    sigma = torch.log(s)
    v = torch.linalg.solve(_sim3_V(w, sigma), t[..., None])[..., 0]
    return torch.cat([v, w, sigma[..., None]], dim=-1)


def sim3_inverse(s, R, t):
    si = 1.0 / s
    Rt = R.transpose(-1, -2)
    return si, Rt, -si[..., None] * _mv(Rt, t)


def sim3_mul(sa, Ra, ta, sb, Rb, tb):
    return sa * sb, Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta
