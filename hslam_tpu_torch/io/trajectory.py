"""Trajectory export and ATE evaluation (port of hslam_tpu/io/trajectory.py).

TUM-format trajectory files (`timestamp tx ty tz qx qy qz qw` per line),
nearest-timestamp association and Sim3-aligned ATE-RMSE, in numpy. The
quaternions of `write_tum` have the JAX package's float32 bits, so both
packages write the same bytes for the same poses.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..utils import lie


def _tum_quats(Rs) -> np.ndarray:
    """(N, 3, 3) rotations -> (N, 4) unit quaternions [x, y, z, w], w >= 0,
    with the bits of the JAX package's eager float32 lie.rot_to_quat: the
    same construction (the best-conditioned of four) op for op in numpy
    float32, whose arithmetic is IEEE as XLA's (torch's float32 sqrt is
    not always correctly rounded), and the norm as XLA fuses it, one
    sequential multiply-add chain, emulated in float64 (where a product of
    two float32 values is exact)."""
    R = np.asarray(Rs, np.float32)
    m = [[R[:, i, j] for j in range(3)] for i in range(3)]
    f32 = np.float32

    def sq(x):
        return np.sqrt(np.maximum(x, f32(lie._EPS))) * f32(0.5)

    tr = m[0][0] + m[1][1] + m[2][2]
    qw0 = sq(f32(1.0) + tr)
    qx1 = sq(f32(1.0) + m[0][0] - m[1][1] - m[2][2])
    qy2 = sq(f32(1.0) - m[0][0] + m[1][1] - m[2][2])
    qz3 = sq(f32(1.0) - m[0][0] - m[1][1] + m[2][2])
    four = f32(4.0)
    cases = np.stack([
        np.stack([m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1], four * qw0 * qw0],
                 -1) / (four * qw0[:, None]),
        np.stack([four * qx1 * qx1, m[0][1] + m[1][0], m[0][2] + m[2][0], m[2][1] - m[1][2]],
                 -1) / (four * qx1[:, None]),
        np.stack([m[0][1] + m[1][0], four * qy2 * qy2, m[1][2] + m[2][1], m[0][2] - m[2][0]],
                 -1) / (four * qy2[:, None]),
        np.stack([m[0][2] + m[2][0], m[1][2] + m[2][1], four * qz3 * qz3, m[1][0] - m[0][1]],
                 -1) / (four * qz3[:, None]),
    ], 1)
    scores = np.stack([tr, m[0][0] - m[1][1] - m[2][2], m[1][1] - m[0][0] - m[2][2],
                       m[2][2] - m[0][0] - m[1][1]], -1)
    q = cases[np.arange(len(R)), np.argmax(scores, -1)]
    d = q.astype(np.float64)
    n2 = (d[:, 0] * d[:, 0]).astype(f32)
    for i in range(1, 4):
        n2 = (d[:, i] * d[:, i] + n2).astype(f32)
    q = q / np.maximum(np.sqrt(n2), f32(lie._EPS))[:, None]
    return q * np.where(q[:, 3:4] < 0, f32(-1.0), f32(1.0))


def write_tum(path: str, timestamps: Sequence[float],
              poses: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """TUM format: `timestamp tx ty tz qx qy qz qw` per line.
    poses are camToWorld (R, t)."""
    poses = list(poses)
    quats = _tum_quats([R for R, _ in poses]) if poses else []
    with open(path, "w") as f:
        for ts, (_, t), q in zip(timestamps, poses, quats):
            f.write(
                f"{ts:.9f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def read_tum(path: str):
    """Returns (timestamps (N,), positions (N, 3), quaternions (N, 4) xyzw)."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            v = [float(x) for x in ln.replace(",", " ").split()]
            if len(v) < 8:
                continue
            ts.append(v[0])
            pos.append(v[1:4])
            quat.append(v[4:8])
    return np.array(ts), np.array(pos), np.array(quat)


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_diff: float = 0.02):
    """Greedy nearest-timestamp association; returns index pairs."""
    ia = np.argsort(ts_a)
    ib = np.argsort(ts_b)
    pairs = []
    j = 0
    for i in ia:
        while j + 1 < len(ib) and abs(ts_b[ib[j + 1]] - ts_a[i]) <= abs(
            ts_b[ib[j]] - ts_a[i]
        ):
            j += 1
        if abs(ts_b[ib[j]] - ts_a[i]) < max_diff:
            pairs.append((i, ib[j]))
    return pairs


def align_sim3(X: np.ndarray, Y: np.ndarray):
    """Umeyama alignment: find s, R, t minimizing ||Y - (s R X + t)||.
    X, Y: (N, 3). Needed because monocular trajectories have free scale."""
    mx = X.mean(0)
    my = Y.mean(0)
    Xc = X - mx
    Yc = Y - my
    cov = Yc.T @ Xc / len(X)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    var_x = (Xc**2).sum() / len(X)
    s = np.trace(np.diag(S) @ D) / var_x if var_x > 0 else 1.0
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(gt_pos: np.ndarray, est_pos: np.ndarray,
             align: str = "sim3") -> float:
    """Absolute trajectory error RMSE after sim3 (monocular) or se3
    alignment. Positions must already be associated (same length)."""
    if len(gt_pos) < 3:
        return float("nan")
    if align == "sim3":
        s, R, t = align_sim3(est_pos, gt_pos)
    else:
        s = 1.0
        _, R, t = align_sim3(est_pos, gt_pos)  # reuse, fix scale
        # re-estimate t with s=1
        t = gt_pos.mean(0) - R @ est_pos.mean(0)
    aligned = (s * (R @ est_pos.T)).T + t
    err = aligned - gt_pos
    return float(np.sqrt((err**2).sum(-1).mean()))


def evaluate_ate(gt_file: str, est_file: str, max_diff: float = 0.02) -> float:
    ts_g, pos_g, _ = read_tum(gt_file)
    ts_e, pos_e, _ = read_tum(est_file)
    pairs = associate(ts_g, ts_e, max_diff)
    if len(pairs) < 3:
        return float("nan")
    gi = np.array([p[0] for p in pairs])
    ei = np.array([p[1] for p in pairs])
    return ate_rmse(pos_g[gi], pos_e[ei])
