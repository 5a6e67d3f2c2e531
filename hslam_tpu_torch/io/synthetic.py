"""Synthetic monocular sequences in numpy: a textured plane at fixed depth
seen by a moving pinhole camera (the scene of bench.py:48-109).

Texture: a sum of 8 sinusoids plus Gaussian blobs (corner-bearing micro
structure), clipped to [2, 253]. The sinusoid coefficients come from
np.random.default_rng instead of jax.random, so the frames are the same
wherever they are rendered, and both packages can be fed identical input.
Camera: `arc_xi` is bench.py's arc; poses are worldToCam (R, t) =
se3_exp(xi), and the ground-truth camera centre is -R^T t.
`sweep_texture`, `sweep_render` and `longrun_frames` are tests/test_system.py's
scene and tests/test_longrun.py's 500-frame sweep in torch.
`make_loop_frames` continues a rendered arc into bench.py's loop sequence:
the arc again under exposure flicker, a flight back to the start, and the
first seconds re-traced. `make_photocal_frames` renders the arc through an
unmodelled response, vignette and exposure (bench.py's photocal phase).

Datasets on disk: `write_euroc` and `write_tum` render the arc through a
real lens (any camera.txt model: each raw pixel's ray comes from inverting
io/calib_io's distortion) at the sensor's size, and lay the frames out as
EuRoC (`mav0/cam0/data/<ns>.png`, ground truth in
`mav0/state_groundtruth_estimate0/data.csv`) or TUM monoVO (`images.zip`,
`times.txt` with exposures, `pcalib.txt`, `vignette.png`,
`groundtruth.txt`) sequences, which io/dataset.DatasetReader reads.
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


# tests/test_system.py's scene (make_texture, render: :13-45): a 96x128
# texture of 8 sinusoids on a plane at depth 2.0, seen by an fx = fy = 80
# pinhole camera. Its 24 random numbers are jax.random's float32 draws,
# copied because torch cannot reproduce them: uniform(PRNGKey(3), (2, 8),
# 0.5, 6.5) gives the rows (ky, kx), uniform(fold_in(PRNGKey(3), 1), (8,))
# the phases before their factor 6.28.
SWEEP_H, SWEEP_W, SWEEP_F, SWEEP_DEPTH = 96, 128, 80.0, 2.0
SWEEP_KY = (0.9443154335021973, 6.128866195678711, 4.393742084503174, 6.353725910186768,
            2.170266628265381, 3.9976284503936768, 1.1390330791473389, 2.789396286010742)
SWEEP_KX = (1.765484094619751, 1.2677733898162842, 4.921466827392578, 1.4367740154266357,
            2.3054685592651367, 2.041592836380005, 6.31342887878418, 1.1471469402313232)
SWEEP_PH = (0.02599465847015381, 0.5417391061782837, 0.4810216426849365, 0.6201950311660767,
            0.38016772270202637, 0.13980019092559814, 0.21593129634857178, 0.27272164821624756)
SWEEP_AMPS = (35.0, 30.0, 22.0, 18.0, 14.0, 10.0, 8.0, 6.0)
# tests/test_longrun.py's sequence: 500 frames at t = i / 10 along
# longrun_xi under the unmodelled gain longrun_gain(i)
LONGRUN_FRAMES = 500


def _grid(h, w, device):
    import torch
    return torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                          indexing="ij")


def sweep_texture(device="cpu"):
    """tests/test_system.py's make_texture: a float32 (96, 128) tensor."""
    import torch
    f32 = dict(dtype=torch.float32, device=device)
    ky, kx = torch.tensor(SWEEP_KY, **f32), torch.tensor(SWEEP_KX, **f32)
    ph = torch.tensor(SWEEP_PH, **f32) * 6.28
    amps = torch.tensor(SWEEP_AMPS, **f32)
    ys, xs = _grid(SWEEP_H, SWEEP_W, device)
    acc = 0
    for i in range(8):
        acc = acc + amps[i] * torch.sin(
            2 * np.pi * (kx[i] * xs / SWEEP_W + ky[i] * ys / SWEEP_H) + ph[i])
    return 120.0 + acc


def sweep_render(I0, R, t):
    """tests/test_system.py's render: the texture `I0` seen by the camera
    with worldToCam (R, t) (float32 tensors on I0's device)."""
    from ..utils import lie
    from ..utils.interp import bilinear
    H, W = I0.shape
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    ys, xs = _grid(H, W, I0.device)
    px = (xs - cx) / SWEEP_F
    py = (ys - cy) / SWEEP_F
    Rinv, tinv = lie.se3_inverse(R, t)
    dz = Rinv[2, 0] * px + Rinv[2, 1] * py + Rinv[2, 2]
    s = (SWEEP_DEPTH - tinv[2]) / dz
    X = s * (Rinv[0, 0] * px + Rinv[0, 1] * py + Rinv[0, 2]) + tinv[0]
    Y = s * (Rinv[1, 0] * px + Rinv[1, 1] * py + Rinv[1, 2]) + tinv[1]
    return bilinear(I0, SWEEP_F * X / SWEEP_DEPTH + cx, SWEEP_F * Y / SWEEP_DEPTH + cy)


def longrun_xi(t: float) -> np.ndarray:
    """tests/test_longrun.py's slow lissajous sweep (twist at time t)."""
    return np.array([
        0.45 * np.sin(0.23 * t), 0.3 * np.sin(0.31 * t + 1.0), 0.12 * np.sin(0.17 * t),
        0.03 * np.sin(0.19 * t), 0.04 * np.sin(0.13 * t + 0.4), 0.02 * np.sin(0.29 * t),
    ], np.float64)


def longrun_gain(i: int) -> float:
    """tests/test_longrun.py's unmodelled exposure flicker of frame i."""
    return 1.0 + 0.1 * np.sin(0.9 * i)


def longrun_frames(n: int = LONGRUN_FRAMES, device="cpu"):
    """tests/test_longrun.py's frames, rendered with torch on `device`:
    frame i seen from se3_exp(longrun_xi(i / 10)) in float32, times
    longrun_gain(i) in float64, clipped to [0, 255] and rounded to float32
    (as the JAX package's process_frame takes the float64 frame). Returns
    (float32 host frames, timestamps, ground-truth camToWorld (4, 4))."""
    import torch

    from ..utils import lie
    I0 = sweep_texture(device)
    frames, stamps, gt = [], [], []
    for i in range(n):
        xi = torch.tensor(longrun_xi(i / 10.0), dtype=torch.float32, device=device)
        R, t = lie.se3_exp(xi)
        img = sweep_render(I0, R, t).double() * longrun_gain(i)
        frames.append(torch.clamp(img, 0.0, 255.0).float())
        Tcw = np.eye(4)
        Tcw[:3, :3], Tcw[:3, 3] = R.cpu().numpy(), t.cpu().numpy()
        gt.append(np.linalg.inv(Tcw))
        stamps.append(i / 10.0)
    return [f.cpu().numpy() for f in frames], stamps, gt


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
        return self.render_rays(R, t, self._px, self._py)

    def render_rays(self, R: np.ndarray, t: np.ndarray, px: np.ndarray,
                    py: np.ndarray) -> np.ndarray:
        """Float32 intensities along the normalized camera rays (px, py, 1)
        of a camera with worldToCam (R, t): any lens, see `lens_rays`."""
        Rinv = R.T
        tinv = -Rinv @ t
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
    vignette = radial_vignette((scene.height, scene.width), vignette_a2)
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


# EuRoC MH_01's cam0 (its sensor.yaml): RadTan intrinsics and distortion at
# 752x480, cropped to 640x480 as the reference's example calibration does
EUROC_CAMERA = ("RadTan 458.654 457.296 367.215 248.375 -0.28340811 0.07395907 "
                "0.00019359 1.76187114e-05\n752 480\ncrop\n640 480\n")
# a TUM monoVO-style FOV camera: normalized intrinsics and the FOV parameter
# at 1280x1024, cropped to 640x480
TUM_CAMERA = ("FOV 0.535719308086809 0.669566858850269 0.493248545285398 "
              "0.500408664348414 0.897966326944875\n1280 1024\ncrop\n640 480\n")
EUROC_T0_NS = 1403636579763555584      # MH_01's first camera timestamp
# the plane seen by write_euroc's and write_tum's sensors: a texture wide
# enough for their rays (up to ~1.9 normalized at the FOV lens's corners),
# with the blob density of Scene's 640x480 default
DATASET_SCENE = dict(height=960, width=1280, fx=320.0, n_blobs=1600)
DATASET_FRAMES = 60


def lens_rays(cam) -> Tuple[np.ndarray, np.ndarray]:
    """The ideal normalized ray (x, y) of every raw pixel of the
    io/calib_io.CameraModel `cam`: its distortion inverted by Newton steps
    (a finite-difference 2x2 Jacobian per pixel). Raises if a pixel did
    not converge to 1e-9."""
    from .calib_io import _distort
    w, h = cam.in_size
    fx, fy, cx, cy = cam.params[:4]
    d = cam.params[4:]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xd, yd = (xs - cx) / fx, (ys - cy) / fy
    x, y = xd.copy(), yd.copy()
    eps = 1e-7
    for _ in range(12):
        x0, y0 = _distort(cam.model, d, x, y)
        ax, ay = _distort(cam.model, d, x + eps, y)
        bx, by = _distort(cam.model, d, x, y + eps)
        j00, j01 = (ax - x0) / eps, (bx - x0) / eps
        j10, j11 = (ay - y0) / eps, (by - y0) / eps
        rx, ry = xd - x0, yd - y0
        det = j00 * j11 - j01 * j10
        x = x + (j11 * rx - j01 * ry) / det
        y = y + (j00 * ry - j10 * rx) / det
    x0, y0 = _distort(cam.model, d, x, y)
    err = float(np.max(np.hypot(x0 - xd, y0 - yd)))
    if not err < 1e-9:
        raise ArithmeticError(f"lens_rays: distortion not inverted ({err:.3g})")
    return x, y


def _lens_frames(root, camera_txt, scene, n_frames, path, photometric=None):
    """Write camera.txt, then render the raw frames along `path` on a pool
    of threads: uint8 sensor images, through `photometric(camera)(i,
    irradiance) -> raw` when given. Returns (camera, the frames' PNG
    encodings, poses camToWorld (R, t), sha256 of the frames)."""
    import hashlib
    import os
    from concurrent.futures import ThreadPoolExecutor

    from .calib_io import parse_camera_txt
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "camera.txt"), "w") as f:
        f.write(camera_txt)
    cam = parse_camera_txt(os.path.join(root, "camera.txt"))
    px, py = lens_rays(cam)
    sensor = None if photometric is None else photometric(cam)

    def frame(i):
        R, t = se3_exp_np(path(i))
        img = scene.render_rays(R, t, px, py).astype(np.float64)
        if sensor is not None:
            img = sensor(i, img)
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
        return img, _png(img), (R.T, -R.T @ t)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        out = list(ex.map(frame, range(n_frames)))
    digest = hashlib.sha256()
    for img, _, _ in out:
        digest.update(img.tobytes())
    return cam, [x[1] for x in out], [x[2] for x in out], digest.hexdigest()


def radial_vignette(shape, a2: float) -> np.ndarray:
    """1 + a2 r^2 over an (H, W) sensor, r normalized to its corner (the
    calibrator's radial basis)."""
    h, w = shape
    ys, xs = np.mgrid[0:h, 0:w]
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    return 1.0 + a2 * (((xs - cx) ** 2 + (ys - cy) ** 2) / (cx ** 2 + cy ** 2))


def _png(img) -> bytes:
    import cv2
    ok, buf = cv2.imencode(".png", img)
    if not ok:
        raise OSError("cv2.imencode failed")
    return buf.tobytes()


def _quat_xyzw(R) -> np.ndarray:
    import torch

    from ..utils import lie
    return lie.rot_to_quat(torch.as_tensor(R, dtype=torch.float64)).numpy()


def write_euroc(root: str, scene: Scene, n_frames: int) -> dict:
    """An EuRoC-layout sequence of the arc: `mav0/cam0/data/<ns>.png` with
    `mav0/cam0/data.csv`, the camera centres and orientations in
    `mav0/state_groundtruth_estimate0/data.csv` (ns, p xyz, q wxyz) and
    `camera.txt`. Returns timestamps (s), camToWorld poses, the camera and
    the frames' sha256."""
    import os
    cam, pngs, poses, sha = _lens_frames(root, EUROC_CAMERA, scene, n_frames,
                                         lambda i: arc_xi(0.05 * i))
    data = os.path.join(root, "mav0", "cam0", "data")
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(data, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    ns = [EUROC_T0_NS + 50_000_000 * i for i in range(n_frames)]      # 20 Hz
    rows, gt_rows = [], []
    for k, png, (R, c) in zip(ns, pngs, poses):
        with open(os.path.join(data, f"{k}.png"), "wb") as f:
            f.write(png)
        rows.append(f"{k},{k}.png")
        q = _quat_xyzw(R)
        gt_rows.append(",".join([str(k)] + [repr(float(x)) for x in (*c, q[3], q[0], q[1], q[2])]))
    with open(os.path.join(root, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], "
                "q_RS_x [], q_RS_y [], q_RS_z []\n" + "\n".join(gt_rows) + "\n")
    return dict(timestamps=[k * 1e-9 for k in ns], poses=poses, camera=cam, sha256=sha)


def write_tum(root: str, scene: Scene, n_frames: int, camera_txt: str = TUM_CAMERA,
              dt: float = 0.05, path=lambda i: arc_xi(0.05 * i)) -> dict:
    """A TUM monoVO-layout sequence (the arc by default), seen through the
    response G(x) = 255 (x / 255)^0.7, the vignette 1 - 0.45 r^2 (r
    normalized to the sensor's corner) and the exposures 1 + 0.25 sin(0.3 i):
    `images.zip` (images/NNNNN.png), `times.txt` (id, seconds, exposure),
    `pcalib.txt` (G at 0..255), a 16-bit `vignette.png`, `groundtruth.txt`
    (TUM format) and `camera.txt`. Returns timestamps, exposures, camToWorld
    poses, the camera and the frames' sha256."""
    import os
    import zipfile

    import cv2

    from .trajectory import write_tum as write_tum_file
    exps = [1.0 + 0.25 * np.sin(0.3 * i) for i in range(n_frames)]
    vig = []

    def photometric(cam):
        vig.append(radial_vignette(cam.in_size[::-1], -0.45))
        return lambda i, irr: 255.0 * np.clip(exps[i] * vig[0] * irr / 255.0, 0.0, 1.0) ** 0.7

    cam, pngs, poses, sha = _lens_frames(root, camera_txt, scene, n_frames, path, photometric)
    stamps = [i * dt for i in range(n_frames)]
    with zipfile.ZipFile(os.path.join(root, "images.zip"), "w") as zf:
        for i, png in enumerate(pngs):
            zf.writestr(f"images/{i:05d}.png", png)
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.writelines(f"{i:05d} {stamps[i]:.6f} {exps[i]:.6f}\n" for i in range(n_frames))
    with open(os.path.join(root, "pcalib.txt"), "w") as f:
        f.write(" ".join(f"{255.0 * (x / 255.0) ** 0.7!r}" for x in range(256)) + "\n")
    if not cv2.imwrite(os.path.join(root, "vignette.png"),
                       np.round(65535.0 * vig[0]).astype(np.uint16)):
        raise OSError("cv2.imwrite failed for vignette.png")
    write_tum_file(os.path.join(root, "groundtruth.txt"), stamps, poses)
    return dict(timestamps=stamps, exposures=exps, poses=poses, camera=cam, sha256=sha)


def tracker_case(height: int = 480, width: int = 640, levels: int = 6, n_points: int = 2048,
                 n_hyp: int = 32, seed: int = 0, device="cpu") -> dict:
    """One frame-to-keyframe tracking problem on the plane, for the
    tracker's tests and timings at any shape: the template of `n_points`
    random pixels of the reference view at the plane's depth (90% valid),
    the target view's pyramid (moved by the twist `xi`, brightness
    1.1 I + 3), the levels' intrinsics and `n_hyp` start hypotheses around
    the truth (the first the identity, the last four far off, so that they
    score inf). All tensors on `device`."""
    import torch

    from ..models.calib import k_pyr_from_value
    from ..ops import tracker as trk
    from ..ops.pyramid import build_direct_pyramid

    rng = np.random.default_rng(seed)
    fx = 0.5 * width
    scene = Scene(height, width, fx, n_blobs=max(16, height * width // 768))
    xi = np.array([0.03, -0.01, 0.02, 0.004, -0.006, 0.002])
    R, t = se3_exp_np(xi)
    ref = scene.render(np.eye(3), np.zeros(3))
    tgt = np.clip(1.1 * scene.render(R, t) + 3.0, 0.0, 255.0).astype(np.float32)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    ref_pyr, _ = build_direct_pyramid(dev(ref), levels)
    tgt_pyr, _ = build_direct_pyramid(dev(tgt), levels)
    u = rng.uniform(4.0, width - 5.0, n_points)
    v = rng.uniform(4.0, height - 5.0, n_points)
    template = trk.build_template(
        dev(u), dev(v), dev(np.full(n_points, 1.0 / scene.depth)),
        dev(rng.uniform(0.5, 2.0, n_points)), dev(rng.uniform(size=n_points) > 0.1, torch.bool),
        ref_pyr)
    K_pyr = k_pyr_from_value(dev([fx, fx, scene.cx, scene.cy]), levels)
    xis = xi + rng.normal(0.0, 0.01, (n_hyp, 6))
    xis[0] = 0.0
    xis[-4:, :3] = [[5.0, 0.0, 0.0], [0.0, 5.0, 0.0], [-5.0, 0.0, 0.0], [0.0, -5.0, 0.0]]
    poses = [se3_exp_np(x) for x in xis]
    return dict(template=template, target_pyr=tgt_pyr, K_pyr=K_pyr,
                R_b=dev(np.stack([p[0] for p in poses])), t_b=dev(np.stack([p[1] for p in poses])),
                aff0=dev([0.0, 0.0]), exp_ref=dev(1.0), exp_new=dev(1.0),
                aff_ref=dev([0.0, 0.0]), R=R, t=t)
