"""Batched bilinear sampling on image planes (port of
hslam_tpu/utils/interp.py).

Images are (H, W) or (H, W, C); x = column, y = row, pixel centers at
integer coordinates. Coordinates are clamped to the image and the cell
index to [0, W-2] x [0, H-2] (interp.py:25-29), so edge samples stay exact
and every gather index is in range; callers carry validity masks.
"""
from __future__ import annotations

import torch


def _cell(H, W, x, y):
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    ix = torch.clamp(torch.floor(x).long(), 0, max(W - 2, 0))
    iy = torch.clamp(torch.floor(y).long(), 0, max(H - 2, 0))
    return x - ix.to(x.dtype), y - iy.to(y.dtype), iy * W + ix


def bilinear(img, x, y):
    """Sample img (H, W) or (H, W, C) at float coords x, y (any batch
    shape). Weights [(1-dx)(1-dy), dx(1-dy), (1-dx)dy, dx dy]."""
    H, W = img.shape[0], img.shape[1]
    dx, dy, base = _cell(H, W, x, y)
    flat = img.reshape((H * W,) + tuple(img.shape[2:]))
    p00 = flat[base]
    p01 = flat[base + 1]
    p10 = flat[base + W]
    p11 = flat[base + W + 1]
    if img.dim() == 3:
        dx = dx[..., None]
        dy = dy[..., None]
    top = p00 * (1.0 - dx) + p01 * dx
    bot = p10 * (1.0 - dx) + p11 * dx
    return top * (1.0 - dy) + bot * dy


def bilinear_stack(imgs, x, y):
    """Sample each image of a stack imgs (B, H, W) at its own float coords
    x, y (B, ...): bilinear on every plane, in one gather."""
    B, H, W = imgs.shape
    dx, dy, base = _cell(H, W, x, y)
    base = base + (torch.arange(B, device=imgs.device) * (H * W)).reshape(
        (B,) + (1,) * (x.dim() - 1))
    flat = imgs.reshape(-1)
    top = flat[base] * (1.0 - dx) + flat[base + 1] * dx
    bot = flat[base + W] * (1.0 - dx) + flat[base + W + 1] * dx
    return top * (1.0 - dy) + bot * dy


def bilinear_with_grad(img, x, y):
    """(value, gx, gy) with gx/gy the bilinear finite differences of the
    2x2 cell (getInterpolatedElement33BiLin semantics)."""
    H, W = img.shape
    dx, dy, base = _cell(H, W, x, y)
    flat = img.reshape(H * W)
    tl = flat[base]
    tr = flat[base + 1]
    bl = flat[base + W]
    br = flat[base + W + 1]
    top = dx * tr + (1.0 - dx) * tl
    bot = dx * br + (1.0 - dx) * bl
    left = dy * bl + (1.0 - dy) * tl
    right = dy * br + (1.0 - dy) * tr
    val = dx * right + (1.0 - dx) * left
    return val, right - left, bot - top


def pack_cells(img):
    """(H, W) -> (H, W, 4) = [I(y,x), I(y,x+1), I(y+1,x), I(y+1,x+1)];
    the last row/col duplicate their neighbours."""
    r = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    d = torch.cat([img[1:, :], img[-1:, :]], dim=0)
    rd = torch.cat([r[1:, :], r[-1:, :]], dim=0)
    return torch.stack([img, r, d, rd], dim=-1)


def bilinear_packed(packed, x, y):
    """Sample a pack_cells() image with one gather per sample."""
    H, W = packed.shape[0], packed.shape[1]
    dx, dy, base = _cell(H, W, x, y)
    cells = packed.reshape(H * W, 4)[base]
    top = cells[..., 0] * (1 - dx) + cells[..., 1] * dx
    bot = cells[..., 2] * (1 - dx) + cells[..., 3] * dx
    return top * (1 - dy) + bot * dy


def in_bounds(x, y, width, height, border: float = 1.1, margin: float = 3.0):
    return (x > border) & (y > border) & (x < width - margin) & (y < height - margin)
