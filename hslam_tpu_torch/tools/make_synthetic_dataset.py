"""Write a synthetic sequence to disk in the TUM monoVO layout (counterpart
of scripts/make_synthetic_dataset.py): `images/%05d.png`, `times.txt` with
exposures, `camera.txt` (RadTan k1 -0.12, k2 0.03, crop), `pcalib.txt`
(gamma 0.75), a 16-bit `vignette.png` (1 - 0.25 r^2) and `groundtruth.txt`,
so the whole dataset path (reader, prefetching loader, photometric and
geometric correction, SLAM) runs without recorded data.

Usage:
    python -m hslam_tpu_torch.tools.make_synthetic_dataset OUT [--frames 60]
        [--width 320 --height 240] [--device cuda]

The frames are rendered on `device` in float32, as the JAX script renders
them: the texture's 24 draws (8 wave numbers in y and x, 8 phases) come
from numpy (the JAX script's jax.random.PRNGKey(11) cannot be reproduced in
torch) and can be passed in. Everything but the images has the JAX
script's bytes: the text files, the vignette (numpy float32 op for op as
XLA's) and the ground truth, whose poses come from `_se3_exp_f32`, the JAX
package's eager float32 se3_exp emulated in numpy, and whose quaternions
come from io/trajectory's float32 routine (C19). Given the JAX draws, the
images are within one level of the JAX script's.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..io.trajectory import _tum_quats
from ..utils.interp import bilinear

K1, K2 = -0.12, 0.03        # mild radial distortion
DEPTH = 2.0
GAMMA = 0.75                # response exponent
VIG_A = -0.25
AMPS = (35.0, 30.0, 22.0, 18.0, 14.0, 10.0, 8.0, 6.0)


def texture_draws(seed: int = 11):
    """(ky, kx, phases): 8 wave numbers in [0.5, 6.5) per axis, 8 phases."""
    rng = np.random.default_rng(seed)
    ky, kx = rng.uniform(0.5, 6.5, (2, 8))
    return ky, kx, rng.uniform(0.0, 1.0, 8) * 6.28


def _fma_dot(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """float32 A @ B as XLA's CPU dot sums it: a multiply-add chain over
    the inner dimension, each step rounded once (a float32 product is exact
    in float64)."""
    out = np.zeros((A.shape[0], B.shape[1]), np.float32)
    for i in range(A.shape[0]):
        for j in range(B.shape[1]):
            s = np.float32(0.0)
            for k in range(A.shape[1]):
                s = np.float32(np.float64(A[i, k]) * np.float64(B[k, j]) + np.float64(s))
            out[i, j] = s
    return out


def _se3_exp_f32(xi: np.ndarray):
    """hslam_tpu/utils/lie.py se3_exp ([t, w] -> worldToCam R, t) in
    float32 op for op as XLA runs it eagerly on the CPU: sin and cos
    correctly rounded, the 3x3 products as `_fma_dot`. Gives the JAX
    package's bits (0 of 119 poses of this path differ, CPU)."""
    f32 = np.float32
    xi = np.asarray(xi, np.float32)
    v, w = xi[:3], xi[3:]
    th2 = f32(f32(w[0] * w[0] + w[1] * w[1]) + w[2] * w[2])
    if th2 < 1e-8:
        A = f32(f32(1.0) - th2 / f32(6.0))
        B = f32(f32(0.5) - th2 / f32(24.0))
        C = f32(f32(1.0 / 6.0) - th2 / f32(120.0))
    else:
        th = f32(np.sqrt(th2))
        sin, cos = f32(np.sin(np.float64(th))), f32(np.cos(np.float64(th)))
        A = f32(sin / th)
        B = f32(f32(f32(1.0) - cos) / th2)
        C = f32(f32(th - sin) / f32(th2 * th))
    z = f32(0.0)
    Wm = np.array([[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]], np.float32)
    W2 = _fma_dot(Wm, Wm)
    eye = np.eye(3, dtype=np.float32)
    R = (eye + A * Wm) + B * W2
    V = (eye + B * Wm) + C * W2
    return R, _fma_dot(V, v[:, None])[:, 0]


def _path_xi(t: float) -> np.ndarray:
    return np.array([0.30 * np.sin(0.5 * t), 0.15 * (1 - np.cos(0.5 * t)), 0.04 * t,
                     0.012 * np.sin(0.4 * t), 0.02 * t, 0.008 * np.sin(0.3 * t)])


def _vignette(H: int, W: int, cx: float, cy: float) -> np.ndarray:
    """1 + a r^2 (r normalized to the corner) in float32, op for op as the
    JAX script's eager jnp computes it."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dx, dy = xs - np.float32(cx), ys - np.float32(cy)
    r2n = (dx * dx + dy * dy) / np.float32(cx * cx + cy * cy)
    return np.float32(1.0) + np.float32(VIG_A) * r2n


def write_dataset(out: str, frames: int = 60, width: int = 320, height: int = 240,
                  device="cuda", draws: Optional[Sequence[np.ndarray]] = None) -> dict:
    """Render and write the sequence; returns the camera (fx, fy, cx, cy),
    the exposures and the camToWorld poses. `draws` = (ky, kx, phases)."""
    import cv2
    dev = torch.device(device)
    H, W = height, width
    fx = fy = 0.55 * W
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    ky, kx, ph = (np.asarray(d, np.float32) for d in (draws or texture_draws()))
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    tex = 120.0 + sum(AMPS[i] * torch.sin(2 * np.pi * (float(kx[i]) * xs / W
                                                       + float(ky[i]) * ys / H) + float(ph[i]))
                      for i in range(8))
    # each raw pixel's ideal ray: the radial distortion inverted by a fixed
    # point iteration
    xd, yd = (xs - cx) / fx, (ys - cy) / fy
    xr, yr = xd, yd
    for _ in range(15):
        r2 = xr * xr + yr * yr
        radial = 1.0 + K1 * r2 + K2 * r2 * r2
        xr, yr = xd / radial, yd / radial
    vig = _vignette(H, W, cx, cy)
    vig_dev = torch.from_numpy(vig).to(dev)
    gt_lines, times, poses = [], [], []
    for i in range(frames):
        t = i / 30.0
        R, tt = _se3_exp_f32(_path_xi(t))          # worldToCam
        Rinv = torch.from_numpy(R.T.copy()).to(dev)
        tinv = -(Rinv @ torch.from_numpy(tt).to(dev))
        dz = Rinv[2, 0] * xr + Rinv[2, 1] * yr + Rinv[2, 2]
        s = (DEPTH - tinv[2]) / dz
        X = s * (Rinv[0, 0] * xr + Rinv[0, 1] * yr + Rinv[0, 2]) + tinv[0]
        Y = s * (Rinv[1, 0] * xr + Rinv[1, 1] * yr + Rinv[1, 2]) + tinv[1]
        scene = bilinear(tex, fx * X / DEPTH + cx, fy * Y / DEPTH + cy)
        exposure = 1.0 + 0.3 * np.sin(0.8 * t)
        irr = torch.clamp(scene * vig_dev * exposure, 0, 255)
        img8 = torch.clamp(255.0 * (irr / 255.0) ** GAMMA, 0, 255).to(torch.uint8)
        if not cv2.imwrite(os.path.join(out, "images", f"{i:05d}.png"), img8.cpu().numpy()):
            raise OSError(f"cv2.imwrite failed for frame {i}")
        times.append((i, t, exposure))
        Tcw = np.eye(4)
        Tcw[:3, :3], Tcw[:3, 3] = R, tt
        Twc = np.linalg.inv(Tcw)
        poses.append((Twc[:3, :3], Twc[:3, 3]))
        q = _tum_quats([Twc[:3, :3]])[0]
        gt_lines.append(f"{t:.6f} {Twc[0, 3]:.6f} {Twc[1, 3]:.6f} {Twc[2, 3]:.6f} "
                        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}")

    with open(os.path.join(out, "times.txt"), "w") as f:
        for i, t, e in times:
            f.write(f"{i:05d} {t:.6f} {e:.6f}\n")
    with open(os.path.join(out, "camera.txt"), "w") as f:
        f.write(f"RadTan {fx} {fy} {cx} {cy} {K1} {K2} 0.0 0.0\n")
        f.write(f"{W} {H}\ncrop\n{W} {H}\n")
    # response G(i) over 0..255
    resp = 255.0 * (np.arange(256) / 255.0) ** GAMMA
    with open(os.path.join(out, "pcalib.txt"), "w") as f:
        f.write(" ".join(f"{v:.4f}" for v in resp))
    vig16 = np.clip(vig / vig.max() * 65535, 0, 65535).astype(np.uint16)
    if not cv2.imwrite(os.path.join(out, "vignette.png"), vig16):
        raise OSError("cv2.imwrite failed for vignette.png")
    with open(os.path.join(out, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")
    return dict(camera=(fx, fy, cx, cy), exposures=[e for _, _, e in times], poses=poses)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="output dataset directory")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    write_dataset(args.out, args.frames, args.width, args.height, args.device)
    print(f"wrote {args.frames} frames to {args.out}")


if __name__ == "__main__":
    main()
