"""Geometric camera calibration: model parsing, distortion, remap tables
(a copy of hslam_tpu/io/calib_io.py, which the port cannot import: any
hslam_tpu import pulls jax in).

Host-side equivalent of the reference's GeometricUndistorter
(reference: Src/GeometricUndistorter.cpp): supports the same five camera
models (RadTan, Pinhole, Atan/FOV, EquiDistant, KannalaBrandt,
GeometricUndistorter.cpp:310-456) and the three output-K modes
(`crop` optimal-crop search :199-308, `none`, `useK`/fixed-K :94-124).

The remap table is built once per sequence here in numpy; the per-frame
application is the gather of ops/undistort.py, on the card. Calibration
text format follows the reference (camera.txt: model + params / input size
/ mode / output size) and EuRoC-style OpenCV YAML files (Extras/Calib/*.yaml).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CameraModel:
    model: str                 # 'pinhole' | 'radtan' | 'atan' | 'equidistant' | 'kannalabrandt'
    params: np.ndarray         # [fx, fy, cx, cy, d0..] (normalized or absolute)
    in_size: Tuple[int, int]   # (width, height)
    out_size: Tuple[int, int]
    out_K: np.ndarray          # (3, 3) rectified intrinsics
    remap: np.ndarray          # (H_out, W_out, 2) float32 (x, y) source coords
    valid: np.ndarray          # (H_out, W_out) bool


def _distort(model: str, d: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Apply lens distortion to ideal normalized coords (x, y)."""
    if model == "pinhole":
        return x, y
    if model == "radtan":
        k1, k2, p1, p2 = d[:4]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return xd, yd
    if model == "atan":
        w = d[0]
        r = np.sqrt(x * x + y * y)
        fac = np.where(
            r < 1e-8, 1.0, np.arctan(2.0 * r * np.tan(w * 0.5)) / (w * np.maximum(r, 1e-12))
        )
        return x * fac, y * fac
    if model in ("equidistant", "kannalabrandt"):
        # theta-polynomial fisheye: r_d = th + k1 th^3 + k2 th^5 + k3 th^7 + k4 th^9
        k1, k2, k3, k4 = d[:4]
        r = np.sqrt(x * x + y * y)
        th = np.arctan(r)
        th2 = th * th
        th_d = th * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
        fac = np.where(r < 1e-8, 1.0, th_d / np.maximum(r, 1e-12))
        return x * fac, y * fac
    raise ValueError(f"unknown camera model {model}")


def _build_remap(model: str, params: np.ndarray, in_size, out_size, out_K):
    """For each output pixel: ideal ray -> distort -> input pixel."""
    w_in, h_in = in_size
    w_out, h_out = out_size
    fx_o, fy_o = out_K[0, 0], out_K[1, 1]
    cx_o, cy_o = out_K[0, 2], out_K[1, 2]
    fx_i, fy_i, cx_i, cy_i = params[:4]

    ys, xs = np.mgrid[0:h_out, 0:w_out].astype(np.float64)
    x_n = (xs - cx_o) / fx_o
    y_n = (ys - cy_o) / fy_o
    xd, yd = _distort(model, params[4:], x_n, y_n)
    u = fx_i * xd + cx_i
    v = fy_i * yd + cy_i
    valid = (u >= 0) & (u < w_in - 1) & (v >= 0) & (v < h_in - 1)
    remap = np.stack([u, v], axis=-1).astype(np.float32)
    remap[~valid] = -1.0
    return remap, valid


def _optimal_K_crop(model, params, in_size, out_size):
    """Largest output K such that every output pixel maps inside the input
    (the reference's iterative optimal-crop search,
    GeometricUndistorter.cpp:199-308 — re-derived, not transcribed):
    shrink/grow focal and center per axis until the border rows/cols of the
    remap stay valid."""
    w_in, h_in = in_size
    w_out, h_out = out_size

    # start from a guess: undistort a grid of input border points to span
    ys, xs = np.mgrid[0:h_in:complex(0, 50), 0:w_in:complex(0, 50)]
    fx_i, fy_i, cx_i, cy_i = params[:4]
    x_n = (xs.reshape(-1) - cx_i) / fx_i
    y_n = (ys.reshape(-1) - cy_i) / fy_i
    # invert distortion numerically (fixed point) to get ideal coords span
    xi, yi = x_n.copy(), y_n.copy()
    for _ in range(20):
        xd, yd = _distort(model, params[4:], xi, yi)
        xi += x_n - xd
        yi += y_n - yd

    # binary search a scale of the span so every output pixel is valid
    def K_for(scale_x, scale_y):
        min_x, max_x = np.min(xi), np.max(xi)
        min_y, max_y = np.min(yi), np.max(yi)
        span_x = (max_x - min_x) * scale_x
        span_y = (max_y - min_y) * scale_y
        mid_x = 0.5 * (min_x + max_x)
        mid_y = 0.5 * (min_y + max_y)
        fx = (w_out - 1) / span_x
        fy = (h_out - 1) / span_y
        cx = -fx * (mid_x - span_x / 2)
        cy = -fy * (mid_y - span_y / 2)
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        return K

    lo, hi = 0.1, 1.0
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        K = K_for(mid, mid)
        _, valid = _build_remap(model, params, in_size, out_size, K)
        # require the full border valid (crop semantics)
        if valid[0, :].all() and valid[-1, :].all() and valid[:, 0].all() and valid[:, -1].all():
            lo = mid
        else:
            hi = mid
    return K_for(lo, lo)


def make_camera(
    model: str,
    params,                      # [fx, fy, cx, cy, distortion...]
    in_size: Tuple[int, int],
    out_size: Optional[Tuple[int, int]] = None,
    mode: str = "crop",          # 'crop' | 'none' | 'useK'
    out_K: Optional[np.ndarray] = None,
) -> CameraModel:
    params = np.asarray(params, dtype=np.float64)
    # the reference accepts normalized intrinsics (<=1 means relative,
    # GeometricUndistorter.cpp LoadGeometricCalibration convention)
    w_in, h_in = in_size
    if params[2] < 1.0 and params[3] < 1.0:
        params = params.copy()
        params[0] *= w_in
        params[1] *= h_in
        params[2] = params[2] * w_in - 0.5
        params[3] = params[3] * h_in - 0.5
    out_size = out_size or in_size

    if mode == "none":
        K = np.array(
            [[params[0], 0, params[2]], [0, params[1], params[3]], [0, 0, 1.0]]
        )
    elif mode == "useK":
        assert out_K is not None
        K = np.asarray(out_K, dtype=np.float64)
    else:  # crop
        K = _optimal_K_crop(model, params, in_size, out_size)

    remap, valid = _build_remap(model, params, in_size, out_size, K)
    return CameraModel(
        model=model, params=params, in_size=in_size, out_size=out_size,
        out_K=K.astype(np.float64), remap=remap, valid=valid,
    )


def stereo_rectify(
    model1: str, params1, model2: str, params2,
    in_size: Tuple[int, int],
    R: np.ndarray,               # (3, 3) points cam1 -> cam2 (x2 = R x1 + T)
    T: np.ndarray,               # (3,)
    out_size: Optional[Tuple[int, int]] = None,
) -> Tuple[CameraModel, CameraModel, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray]:
    """Stereo rectification: the capability of the reference's
    cv::stereoRectify + initUndistortRectifyMap path
    (GeometricUndistorter.cpp:125-156), re-derived from first principles
    (Bouguet-style): find a common rectifying rotation whose x-axis lies
    along the baseline, so corresponding points land on the same output
    row in both remapped images.

    Returns (cam1, cam2, R1, R2, P1, P2): two CameraModels whose remap
    tables feed the existing device gather kernel (ops/undistort.py), the
    per-camera rectifying rotations, and the new projection matrices
    (P2[0, 3] = -fx * baseline).
    """
    params1 = np.asarray(params1, np.float64)
    params2 = np.asarray(params2, np.float64)
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    out_size = out_size or in_size
    w_out, h_out = out_size

    # baseline: cam2 center in cam1 coordinates
    b = -R.T @ T
    bn = np.linalg.norm(b)
    e1 = b / bn
    if e1[0] < 0:      # keep rectified x pointing from cam1 to cam2
        e1 = -e1
        sign = -1.0
    else:
        sign = 1.0
    # e2 perpendicular to e1 and to the mean optical axis (~cam1 z)
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    if n2 < 1e-9:      # degenerate (baseline ~ optical axis): vertical pair
        e2 = np.array([0.0, 1.0, 0.0])
    else:
        e2 = e2 / n2
    e3 = np.cross(e1, e2)
    R1 = np.stack([e1, e2, e3])          # cam1 -> rectified
    R2 = R1 @ R.T                        # cam2 -> rectified (same world
    #                                      orientation as rectified cam1)

    # common pinhole intrinsics for the rectified pair
    f_new = 0.5 * (params1[1] + params2[1])
    cx_new = 0.5 * (w_out - 1)
    cy_new = 0.5 * (h_out - 1)
    K_new = np.array([[f_new, 0, cx_new], [0, f_new, cy_new], [0, 0, 1.0]])
    P1 = np.hstack([K_new, np.zeros((3, 1))])
    P2 = np.hstack([K_new, np.zeros((3, 1))])
    P2[0, 3] = -f_new * bn * sign

    def build(model, params, R_rect):
        ys, xs = np.mgrid[0:h_out, 0:w_out].astype(np.float64)
        rx = (xs - cx_new) / f_new
        ry = (ys - cy_new) / f_new
        rays = np.stack([rx, ry, np.ones_like(rx)], axis=-1)
        cam = rays @ R_rect                  # R_rect^T applied to each ray
        x = cam[..., 0] / cam[..., 2]
        y = cam[..., 1] / cam[..., 2]
        xd, yd = _distort(model, params[4:], x, y)
        u = params[0] * xd + params[2]
        v = params[1] * yd + params[3]
        w_in, h_in = in_size
        valid = ((cam[..., 2] > 0) & (u >= 0) & (u < w_in - 1)
                 & (v >= 0) & (v < h_in - 1))
        remap = np.stack([u, v], axis=-1).astype(np.float32)
        remap[~valid] = -1.0
        return remap, valid

    remap1, valid1 = build(model1, params1, R1)
    remap2, valid2 = build(model2, params2, R2)
    cam1 = CameraModel(model=model1, params=params1, in_size=in_size,
                       out_size=out_size, out_K=K_new, remap=remap1,
                       valid=valid1)
    cam2 = CameraModel(model=model2, params=params2, in_size=in_size,
                       out_size=out_size, out_K=K_new, remap=remap2,
                       valid=valid2)
    return cam1, cam2, R1, R2, P1, P2


def parse_camera_txt(path: str, out_size=None) -> CameraModel:
    """Parse a DSO/TUM-mono style camera.txt (the reference's text format,
    GeometricUndistorter.cpp:26-92):

        <model-or-params line>
        <in_w> <in_h>
        crop | none | fx fy cx cy
        <out_w> <out_h>
    """
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    first = lines[0].split()
    named = {
        "RadTan": "radtan", "Pinhole": "pinhole", "EquiDistant": "equidistant",
        "KannalaBrandt": "kannalabrandt", "FOV": "atan", "ATAN": "atan",
    }
    if first[0] in named:
        model = named[first[0]]
        params = [float(x) for x in first[1:]]
    else:
        vals = [float(x) for x in first]
        if len(vals) == 5:
            model = "atan" if vals[4] != 0 else "pinhole"
            params = vals
        elif len(vals) == 8:
            model = "radtan"
            params = vals
        else:
            model = "pinhole"
            params = vals + [0.0] * (4 - len(vals))
    in_w, in_h = [int(float(x)) for x in lines[1].split()]
    mode_line = lines[2]
    out_w, out_h = (
        [int(float(x)) for x in lines[3].split()] if len(lines) > 3 else (in_w, in_h)
    )
    if out_size is not None:
        out_w, out_h = out_size

    if mode_line.startswith("crop"):
        mode, K = "crop", None
    elif mode_line.startswith("none") or mode_line.startswith("full"):
        mode, K = "none", None
    else:
        vals = [float(x) for x in mode_line.split()]
        fx, fy, cx, cy = vals[:4]
        if cx < 1 and cy < 1:
            fx, fy, cx, cy = fx * out_w, fy * out_h, cx * out_w - 0.5, cy * out_h - 0.5
        mode = "useK"
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    return make_camera(model, params, (in_w, in_h), (out_w, out_h), mode, K)


def parse_opencv_yaml(path: str, out_size=None, mode: str = "crop") -> CameraModel:
    """EuRoC/KITTI-style OpenCV YAML (reference Extras/Calib/*.yaml)."""
    import re

    import yaml

    with open(path) as f:
        txt = f.read()
    txt = re.sub(r"^%YAML.*$", "", txt, flags=re.M)
    txt = txt.replace("!!opencv-matrix", "")
    data = yaml.safe_load(txt)

    def mat(node):
        return np.array(node["data"], dtype=np.float64).reshape(
            node["rows"], node["cols"]
        )

    K = mat(data["camera_matrix"]) if "camera_matrix" in data else mat(data["K"])
    D = (
        mat(data["distortion_coefficients"]).reshape(-1)
        if "distortion_coefficients" in data
        else np.zeros(4)
    )
    w = int(data.get("image_width", 0))
    h = int(data.get("image_height", 0))
    dist_model = str(data.get("distortion_model", "radtan")).lower()
    model = {"plumb_bob": "radtan", "radtan": "radtan",
             "equidistant": "equidistant", "fisheye": "equidistant"}.get(
        dist_model, "radtan")
    params = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]] + list(D[:4]) + [0.0] * max(0, 4 - len(D))
    return make_camera(model, params, (w, h), out_size, mode)
