"""Lens geometry of the configurations' cameras, in plain numpy and torch.

A frozen copy of the published camera models the benchmark's sensors use
(camera.txt as DSO and TUM monoVO define it: model and parameters, input
size, output mode, output size): the RadTan (OpenCV plumb-bob) and FOV
(ATAN, Devernay-Faugeras) distortions, their inversion by Newton steps, and
the "crop" output intrinsics, found by the same bisection over the span of
the undistorted input border that DSO's undistorter runs. The renderer takes
each raw pixel's ray from here, and the reference rectification maps each
output pixel through here. Nothing of the program is imported.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

_NAMED = {"RadTan": "radtan", "Pinhole": "pinhole", "FOV": "atan", "ATAN": "atan"}


@dataclasses.dataclass
class Lens:
    model: str                 # 'pinhole' | 'radtan' | 'atan'
    params: np.ndarray         # absolute [fx, fy, cx, cy, distortion...]
    in_size: Tuple[int, int]   # (width, height) of the raw sensor
    out_size: Tuple[int, int]  # (width, height) of the rectified frame
    out_K: np.ndarray          # (3, 3) rectified intrinsics


def distort(model: str, d, x, y):
    """Ideal normalized coordinates -> distorted normalized coordinates.
    Works on numpy arrays and on torch tensors alike."""
    if model == "pinhole":
        return x, y
    if model == "radtan":
        k1, k2, p1, p2 = (float(v) for v in d[:4])
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return xd, yd
    if model == "atan":
        w = float(d[0])
        xp = _xp(x)
        r = xp.sqrt(x * x + y * y)
        rs = xp.maximum(r, 1e-12 + 0 * r)
        fac = xp.where(r < 1e-8, 1.0 + 0 * r, xp.arctan(2.0 * rs * np.tan(w * 0.5)) / (w * rs))
        return x * fac, y * fac
    raise ValueError(f"unknown camera model {model}")


def _xp(a):
    """numpy for numpy arrays, torch for tensors."""
    if isinstance(a, np.ndarray):
        return np
    import torch
    return torch


def undistort(model: str, d, xd, yd, iters: int = 12):
    """Distorted normalized coordinates -> ideal ones, by Newton steps with
    a finite-difference 2x2 Jacobian per point (float64 in, float64 out)."""
    x, y = xd * 1.0, yd * 1.0
    eps = 1e-7
    for _ in range(iters):
        x0, y0 = distort(model, d, x, y)
        ax, ay = distort(model, d, x + eps, y)
        bx, by = distort(model, d, x, y + eps)
        j00, j01 = (ax - x0) / eps, (bx - x0) / eps
        j10, j11 = (ay - y0) / eps, (by - y0) / eps
        rx, ry = xd - x0, yd - y0
        det = j00 * j11 - j01 * j10
        x = x + (j11 * rx - j01 * ry) / det
        y = y + (j00 * ry - j10 * rx) / det
    return x, y


def _valid_border(model, params, in_size, out_size, K) -> bool:
    """Every border pixel of the output maps inside the input."""
    w_in, h_in = in_size
    w_out, h_out = out_size
    xs = np.concatenate([np.arange(w_out), np.arange(w_out), np.zeros(h_out),
                         np.full(h_out, w_out - 1)]).astype(np.float64)
    ys = np.concatenate([np.zeros(w_out), np.full(w_out, h_out - 1), np.arange(h_out),
                         np.arange(h_out)]).astype(np.float64)
    xd, yd = distort(model, params[4:], (xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1])
    u = params[0] * xd + params[2]
    v = params[1] * yd + params[3]
    return bool(np.all((u >= 0) & (u < w_in - 1) & (v >= 0) & (v < h_in - 1)))


def crop_K(model: str, params: np.ndarray, in_size, out_size) -> np.ndarray:
    """The largest pinhole K whose output border maps inside the input: the
    undistorted span of a 50x50 grid over the input, scaled by a 30-step
    bisection."""
    w_in, h_in = in_size
    w_out, h_out = out_size
    ys, xs = np.mgrid[0:h_in:complex(0, 50), 0:w_in:complex(0, 50)]
    x_n = (xs.reshape(-1) - params[2]) / params[0]
    y_n = (ys.reshape(-1) - params[3]) / params[1]
    xi, yi = x_n.copy(), y_n.copy()
    for _ in range(20):
        xd, yd = distort(model, params[4:], xi, yi)
        xi += x_n - xd
        yi += y_n - yd
    min_x, max_x, min_y, max_y = np.min(xi), np.max(xi), np.min(yi), np.max(yi)

    def K_for(scale):
        span_x, span_y = (max_x - min_x) * scale, (max_y - min_y) * scale
        fx, fy = (w_out - 1) / span_x, (h_out - 1) / span_y
        cx = -fx * (0.5 * (min_x + max_x) - span_x / 2)
        cy = -fy * (0.5 * (min_y + max_y) - span_y / 2)
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    lo, hi = 0.1, 1.0
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        if _valid_border(model, params, in_size, out_size, K_for(mid)):
            lo = mid
        else:
            hi = mid
    return K_for(lo)


def parse_camera_txt(text: str) -> Lens:
    """camera.txt: '<Model> fx fy cx cy d...' / 'w h' / 'crop' / 'w h'.
    Intrinsics below 1 are relative to the input size (the published
    convention: fx * w, cx * w - 0.5)."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    first = lines[0].split()
    if first[0] not in _NAMED:
        raise ValueError(f"camera.txt: unsupported model {first[0]!r}")
    model = _NAMED[first[0]]
    params = np.array([float(v) for v in first[1:]], np.float64)
    w_in, h_in = (int(float(v)) for v in lines[1].split())
    if lines[2].split()[0] != "crop":
        raise ValueError("camera.txt: only the 'crop' output mode is used here")
    w_out, h_out = (int(float(v)) for v in lines[3].split())
    if params[2] < 1.0 and params[3] < 1.0:
        params[0] *= w_in
        params[1] *= h_in
        params[2] = params[2] * w_in - 0.5
        params[3] = params[3] * h_in - 0.5
    K = crop_K(model, params, (w_in, h_in), (w_out, h_out))
    return Lens(model, params, (w_in, h_in), (w_out, h_out), K)
