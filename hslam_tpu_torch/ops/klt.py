"""Batched pyramidal Lucas-Kanade optical flow (port of
hslam_tpu/ops/klt.py): every feature tracks in parallel, per level a fixed
MAX_ITERS of masked GN steps on a WIN x WIN patch (a fixed-count Python
loop, no host sync).
"""
from __future__ import annotations

from typing import List, Optional

import torch

WIN = 21
HALF = WIN // 2
MAX_ITERS = 30
EPS = 0.01


def _patch_coords(x, y):
    d = torch.arange(WIN, dtype=torch.float32, device=x.device) - HALF
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return x[:, None] + dx.reshape(-1)[None, :], y[:, None] + dy.reshape(-1)[None, :]


def _gather(img, x, y):
    H, W = img.shape
    xc = torch.clamp(x, 0.0, W - 1.0)
    yc = torch.clamp(y, 0.0, H - 1.0)
    ix = torch.clamp(torch.floor(xc).long(), 0, W - 2)
    iy = torch.clamp(torch.floor(yc).long(), 0, H - 2)
    fx = xc - ix
    fy = yc - iy
    flat = img.reshape(-1)
    base = iy * W + ix
    return ((flat[base] * (1 - fx) + flat[base + 1] * fx) * (1 - fy)
            + (flat[base + W] * (1 - fx) + flat[base + W + 1] * fx) * fy)


def track(ref_pyr: List[torch.Tensor], tgt_pyr: List[torch.Tensor],
          pts: torch.Tensor, init: Optional[torch.Tensor] = None):
    """Returns (tracked (N, 2), ok (N,), err (N,) mean abs residual)."""
    n_levels = len(ref_pyr)
    N = pts.shape[0]
    if init is None:
        init = pts
    cur = init / 2.0 ** (n_levels - 1)
    ok = torch.ones(N, dtype=torch.bool, device=pts.device)
    err = torch.zeros(N, device=pts.device)
    for lvl in range(n_levels - 1, -1, -1):
        ref, tgt = ref_pyr[lvl], tgt_pyr[lvl]
        Hl, Wl = ref.shape
        p_ref = pts / 2.0 ** lvl
        rx, ry = _patch_coords(p_ref[:, 0], p_ref[:, 1])
        patch_ref = _gather(ref, rx, ry)
        gx = 0.5 * (_gather(ref, rx + 1, ry) - _gather(ref, rx - 1, ry))
        gy = 0.5 * (_gather(ref, rx, ry + 1) - _gather(ref, rx, ry - 1))
        Gxx = (gx * gx).sum(1)
        Gxy = (gx * gy).sum(1)
        Gyy = (gy * gy).sum(1)
        det = Gxx * Gyy - Gxy * Gxy
        invertible = det > 1e-6
        det_s = torch.where(invertible, det, torch.ones_like(det))
        cx, cy = cur[:, 0], cur[:, 1]
        done = ~invertible
        for _ in range(MAX_ITERS):
            tx, ty = _patch_coords(cx, cy)
            r = _gather(tgt, tx, ty) - patch_ref
            bx = (r * gx).sum(1)
            by = (r * gy).sum(1)
            dx = -(Gyy * bx - Gxy * by) / det_s
            dy = -(-Gxy * bx + Gxx * by) / det_s
            cx = cx + torch.where(done, torch.zeros_like(dx), dx)
            cy = cy + torch.where(done, torch.zeros_like(dy), dy)
            done = done | (dx.abs() + dy.abs() < EPS)
        ok = ok & invertible
        cur = torch.stack([cx, cy], -1)
        if lvl > 0:
            cur = cur * 2.0
        else:
            tx, ty = _patch_coords(cx, cy)
            err = (_gather(tgt, tx, ty) - patch_ref).abs().mean(1)
            inb = (cx > HALF) & (cy > HALF) & (cx < Wl - HALF - 1) & (cy < Hl - HALF - 1)
            ok = ok & inb & (err < 30.0)
    return cur, ok, err
