"""Synthetic monocular sequences in numpy: a textured plane at fixed depth
seen by a moving pinhole camera (the scene of bench.py:48-109).

Texture: a sum of 8 sinusoids plus Gaussian blobs (corner-bearing micro
structure), clipped to [2, 253]. The sinusoid coefficients come from
np.random.default_rng instead of jax.random, so the frames are the same
wherever they are rendered, and both packages can be fed identical input.
Camera: `arc_xi` is bench.py's arc; poses are worldToCam (R, t) =
se3_exp(xi), and the ground-truth camera centre is -R^T t.
`make_loop_frames` continues a rendered arc into bench.py's loop sequence:
the arc again under exposure flicker, a flight back to the start, and the
first seconds re-traced. `make_photocal_frames` renders the arc through an
unmodelled response, vignette and exposure (bench.py's photocal phase).
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np


def arc_xi(t: float) -> np.ndarray:
    """bench.py's camera arc (se3 twist [t(3), w(3)] at time t)."""
    return np.array([
        0.35 * np.sin(0.25 * t), 0.22 * (1 - np.cos(0.3 * t)),
        0.10 * np.sin(0.17 * t),
        0.02 * np.sin(0.2 * t), 0.02 * (1 - np.cos(0.15 * t)), 0.01 * t,
    ], np.float64)


# bench.py's loop sequence, in frames
LOOP_REP = 120    # continuing the arc (drift accumulates)
LOOP_RET = 36     # flying back to the start
LOOP_REV = 110    # re-tracing the early trajectory


def sweep_xi(t: float) -> np.ndarray:
    """The faster sweep of tests/test_system.py (frames at t = i / 10)."""
    return np.array([
        0.35 * np.sin(0.5 * t), 0.18 * (1 - np.cos(0.5 * t)), 0.05 * t,
        0.015 * np.sin(0.4 * t), 0.025 * t, 0.01 * np.sin(0.3 * t),
    ], np.float64)


def se3_exp_np(xi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Float64 SE3 exponential ([t, w] ordering, left Jacobian on t)."""
    v, w = xi[:3], xi[3:]
    th = float(np.linalg.norm(w))
    Wm = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-8:
        A, B, C = 1.0, 0.5, 1.0 / 6.0
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th ** 2
        C = (th - np.sin(th)) / th ** 3
    R = np.eye(3) + A * Wm + B * Wm @ Wm
    V = np.eye(3) + B * Wm + C * Wm @ Wm
    return R, V @ v


def _bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    H, W = img.shape
    x = np.clip(x, 0.0, W - 1.0)
    y = np.clip(y, 0.0, H - 1.0)
    ix = np.clip(np.floor(x).astype(np.int64), 0, W - 2)
    iy = np.clip(np.floor(y).astype(np.int64), 0, H - 2)
    dx, dy = x - ix, y - iy
    p00, p01 = img[iy, ix], img[iy, ix + 1]
    p10, p11 = img[iy + 1, ix], img[iy + 1, ix + 1]
    return (p00 * (1 - dx) + p01 * dx) * (1 - dy) + (p10 * (1 - dx) + p11 * dx) * dy


class Scene:
    """A textured plane at `depth` in front of the world origin."""

    def __init__(self, height: int = 480, width: int = 640, fx: float = 320.0,
                 depth: float = 2.0, seed: int = 11, n_blobs: int = 400):
        self.height, self.width = height, width
        self.fx = self.fy = float(fx)
        self.cx, self.cy = width / 2 - 0.5, height / 2 - 0.5
        self.depth = depth
        rng = np.random.default_rng(seed)
        ky, kx = rng.uniform(0.5, 7.5, (2, 8))
        ph = rng.uniform(0.0, 1.0, 8) * 6.28
        amps = np.array([40.0, 30.0, 22.0, 16.0, 12.0, 9.0, 7.0, 5.0])
        ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
        tex = 120.0 + sum(amps[i] * np.sin(2 * np.pi * (kx[i] * xs / width
                                                        + ky[i] * ys / height) + ph[i])
                          for i in range(8))
        r = 6
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        brng = np.random.default_rng(seed + 6)
        for _ in range(n_blobs):
            bx = brng.integers(r, width - r)
            by = brng.integers(r, height - r)
            amp = brng.uniform(18.0, 45.0) * brng.choice([-1.0, 1.0])
            sig = brng.uniform(1.2, 2.6)
            tex[by - r:by + r + 1, bx - r:bx + r + 1] += amp * np.exp(
                -(xx * xx + yy * yy) / (2 * sig * sig))
        self.texture = np.clip(tex, 2.0, 253.0)
        self._px = (xs - self.cx) / self.fx
        self._py = (ys - self.cy) / self.fy

    def render(self, R: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Float32 image seen by the camera with worldToCam (R, t)."""
        Rinv = R.T
        tinv = -Rinv @ t
        px, py = self._px, self._py
        dz = Rinv[2, 0] * px + Rinv[2, 1] * py + Rinv[2, 2]
        s = (self.depth - tinv[2]) / dz
        X = s * (Rinv[0, 0] * px + Rinv[0, 1] * py + Rinv[0, 2]) + tinv[0]
        Y = s * (Rinv[1, 0] * px + Rinv[1, 1] * py + Rinv[1, 2]) + tinv[1]
        u0 = self.fx * X / self.depth + self.cx
        v0 = self.fy * Y / self.depth + self.cy
        return _bilinear(self.texture, u0, v0).astype(np.float32)


def make_sequence(scene: Scene, n_frames: int,
                  path: Callable[[int], np.ndarray] = lambda i: arc_xi(0.05 * i),
                  quantize: bool = True):
    """Render frames along `path` (frame index -> twist). Returns (frames,
    camera centres (N, 3)); frames are uint8 sensor images when quantize."""
    frames: List[np.ndarray] = []
    centres = []
    for i in range(n_frames):
        R, t = se3_exp_np(path(i))
        img = scene.render(R, t)
        if quantize:
            img = np.clip(np.round(img), 0, 255).astype(np.uint8)
        frames.append(img)
        centres.append(-R.T @ t)
    return frames, np.stack(centres)


def make_loop_frames(scene: Scene, n_arc: int, n_rep: int = LOOP_REP,
                     n_ret: int = LOOP_RET, n_rev: int = LOOP_REV):
    """The loop sequence after `n_arc` frames of the arc (bench.py's
    make_loop_frames): run the arc on for `n_rep` frames under exposure
    flicker (drift accumulates: unmodeled gain stresses the affine-brightness
    chain), fly smoothly back to the start over `n_ret` frames, then re-trace
    its first `n_rev` frames, re-observing the early keyframes' views. The
    flicker is a GLOBAL monotone gain, so rBRIEF tap comparisons keep their
    signs. Returns (uint8 frames, camera centres, timestamps)."""
    frames: List[np.ndarray] = []
    centres, stamps = [], []
    idx = n_arc

    def emit(xi):
        nonlocal idx
        R, t = se3_exp_np(xi)
        gain = 1.0 + 0.15 * np.sin(0.8 * idx)
        frames.append(np.clip(np.round(scene.render(R, t) * gain), 0, 255).astype(np.uint8))
        centres.append(-R.T @ t)
        stamps.append(idx * 0.05)
        idx += 1

    t_end = (n_arc - 1) * 0.05
    for k in range(n_rep):
        emit(arc_xi(t_end + (k + 1) * 0.05))
    xi_end = arc_xi(t_end + n_rep * 0.05)
    # return flight: cosine blend from the far end to the arc's start
    for k in range(n_ret):
        a = 0.5 * (1 - np.cos(np.pi * (k + 1) / n_ret))
        emit((1 - a) * xi_end + a * arc_xi(0.0))
    for k in range(n_rev):
        emit(arc_xi(k * 0.05))
    return frames, np.stack(centres), stamps


def make_photocal_frames(scene: Scene, n_frames: int, gamma: float = 0.7,
                         vignette_a2: float = -0.45):
    """bench.py's photocal sequence (bench.py:160-181): the arc seen through
    a nonlinear response G(x) = 255 (x / 255)^gamma, a radial vignette
    1 + a2 r^2 (r normalized to the image corner, as the calibrator's
    radial basis) and the exposure 1 + 0.35 sin(0.45 i), quantized to uint8
    sensor frames. Returns (frames, exposures, camera centres (N, 3))."""
    H, W = scene.height, scene.width
    ys, xs = np.mgrid[0:H, 0:W]
    r2 = ((xs - scene.cx) ** 2 + (ys - scene.cy) ** 2) / (scene.cx ** 2 + scene.cy ** 2)
    vignette = 1.0 + vignette_a2 * r2
    frames: List[np.ndarray] = []
    exps, centres = [], []
    for i in range(n_frames):
        R, t = se3_exp_np(arc_xi(0.05 * i))
        exp = 1.0 + 0.35 * np.sin(0.45 * i)
        irr = np.clip(scene.render(R, t) / 255.0, 0.0, 1.0)
        raw = 255.0 * np.clip(exp * vignette * irr, 0.0, 1.0) ** gamma
        frames.append(np.clip(np.round(raw), 0, 255).astype(np.uint8))
        exps.append(exp)
        centres.append(-R.T @ t)
    return frames, exps, np.stack(centres)
