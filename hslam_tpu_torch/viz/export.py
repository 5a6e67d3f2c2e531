"""Map/trajectory export for offline visualization (port of
hslam_tpu/viz/export.py).

Replaces the reference's Pangolin GUI (Src/Display.cpp, the only output
surface of the reference — SURVEY.md §5) with out-of-core artifacts:
PLY point clouds (world-space map points with intensity) and trajectory
polylines, viewable in Meshlab/CloudCompare.
"""
from __future__ import annotations

import numpy as np

from ..models import window as W


def window_pointcloud(window, calib, min_rel_bs: float = 0.0,
                      max_idepth_var: float = 1e8):
    """Back-project the port's window's active points to world space.

    `min_rel_bs` / `max_idepth_var` filter poorly-triangulated points the
    way the reference's point-cloud view does (Src/Display.cpp:409-412:
    skip if maxRelBaseline < my_minRelBS or 1/(idepth_hessian+0.01) too
    large). The window may live on the card: its poses and point fields are
    copied to the host once. Returns (xyz (M, 3), intensity (M,))."""
    R, t = W.frame_poses(window.frames)       # worldToCam
    R, t = R.cpu().numpy(), t.cpu().numpy()
    fx, fy, cx, cy = calib.value[:4].tolist()

    pts = window.points
    status, host, u, v, idp, col, rel_bs, hess = (
        x.cpu().numpy() for x in (pts.status, pts.host, pts.u, pts.v, pts.idepth,
                                  pts.color[:, 4], pts.max_rel_baseline,
                                  pts.idepth_hessian))
    id_var = 1.0 / (hess + 0.01)

    act = (
        (status == W.PT_ACTIVE) & (idp > 1e-6)
        & (rel_bs >= min_rel_bs) & (id_var <= max_idepth_var)
    )
    idx = np.where(act)[0]
    if idx.size == 0:
        return np.zeros((0, 3)), np.zeros(0)
    h = host[idx]
    z = 1.0 / idp[idx]
    pc = np.stack([(u[idx] - cx) / fx * z, (v[idx] - cy) / fy * z, z], -1)
    # x_world = R^T (x_cam - t), batched over the host keyframes
    xyz = np.einsum("nji,nj->ni", R[h], pc - t[h])
    return xyz, col[idx]


def write_ply(path: str, xyz: np.ndarray, intensity: np.ndarray | None = None):
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if intensity is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            line = f"{xyz[i,0]:.4f} {xyz[i,1]:.4f} {xyz[i,2]:.4f}"
            if intensity is not None:
                c = int(np.clip(intensity[i], 0, 255))
                line += f" {c} {c} {c}"
            f.write(line + "\n")


def write_trajectory_ply(path: str, positions: np.ndarray):
    """Trajectory as a polyline PLY (edges between consecutive poses)."""
    n = len(positions)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {max(n - 1, 0)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p in positions:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        for i in range(n - 1):
            f.write(f"{i} {i+1}\n")
