"""The benchmark's traffic generator: camera streams rendered on the card.

A textured plane at the configuration's depth, seen through the
configuration's real lens at its sensor's size and rate, along the path a
traffic file describes, through the configuration's photometric sensor
model. Everything is made in torch on the device it is given; only uint8
sensor frames leave it.

- Texture, defined over the whole plane (so no path leaves it): a base
  level, a sum of sinusoids in world coordinates (fixed frequencies,
  amplitudes and seeded phases) and Gaussian blobs, a fixed number in each
  square tile of the plane, placed, sized and signed by an integer hash of
  (tile, blob, seed). Clipped to [2, 253]. Its seed is the configuration's
  (the scene is part of the deployment), and frames sample it from an atlas
  of the region they see.
- Lens: each raw pixel's ideal ray, the distortion inverted by Newton steps
  (reference/lens.py).
- Paths: "laps" of a closed ellipse parallel to the plane, or a one-way
  "line"; both with the same small periodic rotation wobble.
- Sensor: irradiance times an unmodelled gain flicker, through an optional
  exposure, radial vignette and gamma response, plus Gaussian read noise,
  rounded to uint8. Every rendered lap draws its own noise and flicker
  phase from the traffic's `noise_seed`.
- The run's seed: the order in which the rendered laps follow the first.
  Every seed sees the same frames, so every seed gives the system the same
  work in another order (the noise of the first frames decides where the
  system initializes and what map it builds, which moved the work of a
  run by 10% from seed to seed).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from slambench.reference import lens as L

_M32 = 0xFFFFFFFF


class Stream(NamedTuple):
    frames: torch.Tensor     # (N, H_in, W_in) uint8, on the host
    stamps: np.ndarray       # (N,) seconds
    exposures: np.ndarray    # (N,) exposure handed to the system (1.0 when unknown)
    centres: np.ndarray      # (N, 3) ground-truth camera centres (world)
    period: int              # frames after which the path repeats (0: never)
    order: List[int]         # the rendered laps in the order they are fed, cycled

    def slot(self, j: int) -> int:
        """The rendered frame fed as the stream's j-th frame; a path that
        never repeats has none past its end (no wrapping)."""
        if not self.period:
            if j >= self.frames.shape[0]:
                raise IndexError(f"the one-way path ran out of frames at frame {j}: no wrapping")
            return j
        lap, i = divmod(j, self.period)
        return self.order[lap % len(self.order)] * self.period + i


def _hash(*keys: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 tensors (all broadcast together)."""
    h = torch.zeros((), dtype=torch.int64, device=keys[0].device)
    for k, mult in zip(keys, (0x27D4EB2D, 0x165667B1, 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)):
        h = ((h ^ (k & _M32)) * mult) & _M32
        h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    h = h ^ (h >> 12)
    h = (h * 0x297A2D39) & _M32
    return h ^ (h >> 15)


def _uniform(h: torch.Tensor, salt: int) -> torch.Tensor:
    """A float in [0, 1) from hash `h` and a salt."""
    return _hash(h, torch.tensor(salt, device=h.device)).to(torch.float64) / 2.0 ** 32


def texture(X: torch.Tensor, Y: torch.Tensor, tex: dict, seed: int) -> torch.Tensor:
    """Intensity of the plane at world coordinates (X, Y), float32."""
    dev = X.device
    rng = np.random.default_rng([seed % 2 ** 32, 0x7E7])
    out = torch.full_like(X, float(tex["base"]))
    for amp, (fx, fy) in zip(tex["sin_amps"], tex["sin_freqs_per_m"]):
        ph = rng.uniform(0.0, 2 * math.pi)
        out = out + amp * torch.sin(2 * math.pi * (fx * X + fy * Y) + ph)
    tile = float(tex["blob_tile_m"])
    ix = torch.floor(X / tile).to(torch.int64)
    iy = torch.floor(Y / tile).to(torch.int64)
    s = torch.tensor(seed % 2 ** 32, dtype=torch.int64, device=dev)
    s_lo, s_hi = tex["blob_sigma_m"]
    a_lo, a_hi = tex["blob_amp"]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            tx, ty = ix + dx, iy + dy
            for b in range(int(tex["blobs_per_tile"])):
                h = _hash(tx, ty, torch.tensor(b, device=dev), s)
                bx = (tx + _uniform(h, 1)) * tile
                by = (ty + _uniform(h, 2)) * tile
                sig = s_lo + (s_hi - s_lo) * _uniform(h, 3)
                amp = (a_lo + (a_hi - a_lo) * _uniform(h, 4)) * torch.where(
                    _uniform(h, 5) < 0.5, -1.0, 1.0)
                d2 = (X - bx) ** 2 + (Y - by) ** 2
                out = out + amp * torch.exp(-d2 / (2 * sig * sig))
    return torch.clamp(out, 2.0, 253.0)


def _sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img (H, W) at texel coordinates (u, v)."""
    H, W = img.shape
    u = torch.clamp(u, 0.0, W - 1.001)
    v = torch.clamp(v, 0.0, H - 1.001)
    iu, iv = u.floor().long(), v.floor().long()
    du, dv = u - iu, v - iv
    p = img[iv, iu] * (1 - du) + img[iv, iu + 1] * du
    q = img[iv + 1, iu] * (1 - du) + img[iv + 1, iu + 1] * du
    return p * (1 - dv) + q * dv


def _rot(w: np.ndarray) -> np.ndarray:
    """Rodrigues: rotation matrix of the axis-angle vector w."""
    th = float(np.linalg.norm(w))
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + math.sin(th) / th * W + (1 - math.cos(th)) / th ** 2 * W @ W


def path_poses(traffic: dict, rate_hz: float, n: int):
    """worldToCam (R (n, 3, 3), t (n, 3)) and camera centres (n, 3) of the
    first n frames of the traffic's path; and its period in frames (0 for a
    path that never repeats)."""
    wob = traffic["wobble_rad"]
    if traffic["path"] == "laps":
        ax, ay = traffic["ellipse_m"]
        period = int(round(float(traffic["lap_s"]) * rate_hz))
        th = 2 * math.pi * np.arange(n) / period
        C = np.stack([ax * np.sin(th), ay * (1 - np.cos(th)), np.zeros(n)], 1)
    elif traffic["path"] == "line":
        period = 0
        th = 2 * math.pi * np.arange(n) / (float(traffic["wobble_period_s"]) * rate_hz)
        step = float(traffic["speed_m_s"]) / rate_hz
        C = np.stack([step * np.arange(n), np.zeros(n), np.zeros(n)], 1)
    else:
        raise ValueError(f"unknown path kind {traffic['path']!r}")
    w = np.stack([wob[0] * np.sin(th), wob[1] * (1 - np.cos(th)), wob[2] * np.sin(th)], 1)
    R = np.stack([_rot(x) for x in w])
    t = -np.einsum("nij,nj->ni", R, C)
    return R, t, C, period


def render_stream(cfg: dict, traffic: dict, seed: int, n_frames: int, device,
                  batch: int = 8) -> Stream:
    """The first `n_frames` raw sensor frames of the cell's stream. A laps
    path renders `traffic["laps_rendered"]` laps (each with its own noise
    and flicker), the first fed first and the others in an order drawn from
    `seed`; a line renders every frame."""
    cam = L.parse_camera_txt(cfg["camera_txt"])
    w_in, h_in = cam.in_size
    rate = float(cfg["rate_hz"])
    scene, sensor = cfg["scene"], cfg["sensor"]
    if traffic["path"] == "laps":
        _, _, _, lap = path_poses(traffic, rate, 1)
        n_frames = lap * int(traffic["laps_rendered"])
    R, t, C, period = path_poses(traffic, rate, n_frames)
    p = cam.params
    ys, xs = torch.meshgrid(torch.arange(h_in, dtype=torch.float64, device=device),
                            torch.arange(w_in, dtype=torch.float64, device=device),
                            indexing="ij")
    x, y = L.undistort(cam.model, p[4:], (xs - p[2]) / p[0], (ys - p[3]) / p[1])
    rays = torch.stack([x, y, torch.ones_like(x)], -1).reshape(-1, 3)
    vig = None
    if sensor.get("vignette_a2") is not None:
        cx, cy = w_in / 2 - 0.5, h_in / 2 - 0.5
        r2 = ((xs - cx) ** 2 + (ys - cy) ** 2) / (cx ** 2 + cy ** 2)
        vig = (1.0 + float(sensor["vignette_a2"]) * r2).reshape(-1)
    idx = np.arange(n_frames)
    exp = np.ones(n_frames)
    if sensor.get("exposure") is not None:
        e = sensor["exposure"]
        exp = 1.0 + e["amp"] * np.sin(e["freq"] * idx)
    lap_of = idx // period if period else np.zeros(n_frames, np.int64)
    noise_seed = int(traffic["noise_seed"])
    flick = traffic["gain_flicker"]
    # each lap's flicker phase and noise come from its own generator
    gen = torch.Generator(device=device)
    laps = sorted(set(lap_of.tolist()))
    phase = {}
    for k in laps:
        gen.manual_seed((noise_seed * 1000003 + k * 7919) % 2 ** 63)
        phase[k] = float(torch.rand((), generator=gen, device=device, dtype=torch.float64))
    gain = 1.0 + flick["amp"] * np.sin(flick["freq"] * idx + 2 * math.pi * np.array(
        [phase[k] for k in lap_of]))
    frames = torch.empty((n_frames, h_in, w_in), dtype=torch.uint8, device=device)
    Rd = torch.as_tensor(R, device=device)
    Cd = torch.as_tensor(C, device=device)
    depth = float(scene["depth_m"])
    sigma = float(sensor["noise_sigma"])

    def plane_points(j, pix):
        """World (X, Y) where the rays `pix` of frames j meet the plane."""
        dw = torch.einsum("pk,bkj->bpj", pix, Rd[j])        # R^T d for each ray
        Cb = Cd[j][:, None, :]
        s = (depth - Cb[..., 2]) / dw[..., 2]
        return Cb[..., 0] + s * dw[..., 0], Cb[..., 1] + s * dw[..., 1]

    # the texture is sampled from an atlas of the plane over the region the
    # frames see (their border rays bound it), at a texel well below a pixel
    grid = rays.reshape(h_in, w_in, 3)
    ring = torch.cat([grid[0], grid[-1], grid[:, 0], grid[:, -1]])
    lo, hi = [math.inf] * 2, [-math.inf] * 2
    for b0 in range(0, n_frames, 64):
        X, Y = plane_points(torch.arange(b0, min(b0 + 64, n_frames), device=device), ring)
        lo = [min(lo[0], float(X.min())), min(lo[1], float(Y.min()))]
        hi = [max(hi[0], float(X.max())), max(hi[1], float(Y.max()))]
    texel = float(scene["atlas_texel_m"])
    x0, y0 = lo[0] - 4 * texel, lo[1] - 4 * texel
    nx = int(math.ceil((hi[0] + 4 * texel - x0) / texel)) + 1
    ny = int(math.ceil((hi[1] + 4 * texel - y0) / texel)) + 1
    atlas = torch.empty((ny, nx), dtype=torch.float32, device=device)
    xs_t = x0 + texel * torch.arange(nx, dtype=torch.float64, device=device)
    for r0 in range(0, ny, 256):
        ys_t = y0 + texel * torch.arange(r0, min(r0 + 256, ny), dtype=torch.float64,
                                         device=device)
        Yg, Xg = torch.meshgrid(ys_t, xs_t, indexing="ij")
        atlas[r0:r0 + len(ys_t)] = texture(Xg, Yg, scene["texture"],
                                           int(scene["texture"]["seed"])).float()
    for k in laps:
        gen.manual_seed((noise_seed * 1000003 + k * 7919 + 1) % 2 ** 63)
        ids = np.flatnonzero(lap_of == k)
        for b0 in range(0, len(ids), batch):
            sel = ids[b0:b0 + batch]
            j = torch.as_tensor(sel, device=device)
            X, Y = plane_points(j, rays)
            irr = _sample(atlas, ((X - x0) / texel).float(), ((Y - y0) / texel).float())
            irr = irr * torch.as_tensor(gain[sel], device=device, dtype=torch.float32)[:, None]
            if sensor.get("gamma") is not None:
                e = torch.as_tensor(exp[sel], device=device, dtype=torch.float32)[:, None]
                if vig is not None:
                    e = e * vig[None].float()
                irr = 255.0 * torch.clamp(e * irr / 255.0, 0.0, 1.0) ** float(sensor["gamma"])
            noise = torch.randn(irr.shape, generator=gen, device=device, dtype=torch.float32)
            raw = torch.clamp(torch.round(irr + sigma * noise), 0, 255)
            frames[j] = raw.reshape(len(sel), h_in, w_in).to(torch.uint8)
    exposures = exp if sensor.get("exposure_known") else np.ones(n_frames)
    order = [0]
    if period:
        rng = np.random.default_rng([seed % 2 ** 32, seed // 2 ** 32, 0x1A95])
        order += (1 + rng.permutation(len(laps) - 1)).tolist()
    return Stream(frames.cpu(), idx / rate, exposures, C, period, order)
