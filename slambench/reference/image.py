"""Plain reference of the frame path: rectification, photometric
correction and the direct image pyramid, in any floating dtype.

Each function re-derives its answer from the raw frame and the published
lens (reference/lens.py), in the precision asked for: float64 for the
reference, bfloat16 for the control. Nothing of the program is imported.
"""
from __future__ import annotations

from typing import List

import torch

from . import lens as L


def rectify(raw: torch.Tensor, cam: L.Lens, dtype=torch.float64) -> torch.Tensor:
    """The raw (H_in, W_in) frame seen by the rectified pinhole camera
    cam.out_K at cam.out_size: each output pixel's ray through the lens's
    distortion into the raw frame, sampled bilinearly; pixels that land
    outside the raw frame are 0."""
    dev = raw.device
    w_in, h_in = cam.in_size
    w_out, h_out = cam.out_size
    K, p = cam.out_K, cam.params
    c = lambda v: torch.tensor(float(v), dtype=dtype, device=dev)  # noqa: E731
    ys, xs = torch.meshgrid(torch.arange(h_out, device=dev).to(dtype),
                            torch.arange(w_out, device=dev).to(dtype), indexing="ij")
    xd, yd = L.distort(cam.model, p[4:], (xs - c(K[0, 2])) / c(K[0, 0]),
                       (ys - c(K[1, 2])) / c(K[1, 1]))
    u = c(p[0]) * xd + c(p[2])
    v = c(p[1]) * yd + c(p[3])
    valid = (u >= 0) & (u < w_in - 1) & (v >= 0) & (v < h_in - 1)
    out = bilinear(raw.to(dtype), u, v)
    return torch.where(valid, out, torch.zeros_like(out))


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img (H, W) or (H, W, C) at float coordinates, clamped to the image,
    with the corner weights (1-dx)(1-dy), dx(1-dy), (1-dx)dy, dx dy."""
    H, W = img.shape[0], img.shape[1]
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    ix = torch.clamp(torch.floor(x).long(), 0, W - 2)
    iy = torch.clamp(torch.floor(y).long(), 0, H - 2)
    dx = x - ix.to(x.dtype)
    dy = y - iy.to(y.dtype)
    if img.dim() == 3:
        dx, dy = dx[..., None], dy[..., None]
    p00, p01 = img[iy, ix], img[iy, ix + 1]
    p10, p11 = img[iy + 1, ix], img[iy + 1, ix + 1]
    return (p00 * (1 - dx) + p01 * dx) * (1 - dy) + (p10 * (1 - dx) + p11 * dx) * dy


def photometric_correct(img: torch.Tensor, inv_response: torch.Tensor,
                        inv_vignette: torch.Tensor) -> torch.Tensor:
    """I' = Binv(I) / V: the inverse response interpolated linearly between
    its 256 entries (intensities outside [0, 255] take the end entries),
    times the inverse vignette map."""
    lut = inv_response.to(img.dtype)
    idx = torch.clamp(img.floor(), 0, 255).long()
    frac = torch.clamp(img - idx.to(img.dtype), 0.0, 1.0)
    out = lut[idx] * (1 - frac) + lut[torch.clamp(idx + 1, max=255)] * frac
    return out * inv_vignette.to(img.dtype)


def pyramid(img: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """Per level (H >> l, W >> l, 3): [I, dI/dx, dI/dy]. Each level is the
    2x2 mean of the one before (an odd last row or column dropped); the
    derivatives are central differences, 0 on the border."""
    out = []
    for lvl in range(n_levels):
        if lvl > 0:
            H, W = img.shape
            i = img[: H // 2 * 2, : W // 2 * 2]
            img = 0.25 * ((i[0::2, 0::2] + i[0::2, 1::2]) + (i[1::2, 0::2] + i[1::2, 1::2]))
        dx = torch.zeros_like(img)
        dy = torch.zeros_like(img)
        dx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
        dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
        out.append(torch.stack([img, dx, dy], -1))
    return out
