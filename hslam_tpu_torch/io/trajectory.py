"""ATE evaluation (numpy only; copy of the evaluation half of
hslam_tpu/io/trajectory.py, whose module imports jax for its TUM writer).
"""
from __future__ import annotations

import numpy as np


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
