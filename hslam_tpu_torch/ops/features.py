"""Multi-scale feature frontend of the indirect layer (port of
hslam_tpu/ops/features.py): the 1.2x feature pyramid, FAST (unioned with
gradient keypoints) and grid NMS per level, IC-angle orientation and
rBRIEF descriptors from rotation-quantized static index tables, sub-pixel
refinement, radius queries and mutual-NN Hamming matching.

Two details decide exact agreement with the JAX package:
  * `jax.image.resize(..., "bilinear")` antialiases when it downsamples: a
    triangle filter widened by the scale, with its weights normalized per
    output sample. `resize_bilinear` builds the same separable weight
    matrices (jax/_src/image/scale.py::compute_weight_mat) and applies them
    as two matrix products.
  * `lax.top_k` puts ties in index order; `orb.grid_nms` sorts stably.
Descriptors are (N, 8) int32 words holding the JAX package's uint32 bits
(see orb.py).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.interp import bilinear
from .orb import BIG, fast_score, grid_nms, hamming_matrix, mutual_nn, pack_bits
from .pyramid import gaussian_blur7

PATCH = 32
PATCH_C = 15            # patch coordinate of the keypoint centre
_BRIEF_R = 14.0         # max BRIEF tap radius
N_BINS = 16             # orientation quantization bins
N_PAIRS = 256
BORDER = PATCH_C + 2    # keypoints keep the whole patch inside the image


class Feats(NamedTuple):
    """Per-window-slot keypoint store (capacity NF per slot)."""

    u: torch.Tensor        # (F, NF) level-0 x
    v: torch.Tensor        # (F, NF) level-0 y
    level: torch.Tensor    # (F, NF) int32 octave
    score: torch.Tensor    # (F, NF)
    desc: torch.Tensor     # (F, NF, 8) int32, 256-bit rBRIEF
    valid: torch.Tensor    # (F, NF) bool


def empty_feats(n_slots: int, capacity: int, device="cuda") -> Feats:
    f32 = dict(dtype=torch.float32, device=device)
    return Feats(
        u=torch.zeros((n_slots, capacity), **f32),
        v=torch.zeros((n_slots, capacity), **f32),
        level=torch.zeros((n_slots, capacity), dtype=torch.int32, device=device),
        score=torch.zeros((n_slots, capacity), **f32),
        desc=torch.zeros((n_slots, capacity, 8), dtype=torch.int32, device=device),
        valid=torch.zeros((n_slots, capacity), dtype=torch.bool, device=device),
    )


def _brief_pattern_clipped(seed: int = 42) -> np.ndarray:
    """(N_PAIRS, 4) Gaussian test pairs radially clipped to _BRIEF_R."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(N_PAIRS, 4) * (31 / 5.0)
    for k in (0, 2):
        r = np.sqrt(pts[:, k] ** 2 + pts[:, k + 1] ** 2)
        f = np.where(r > _BRIEF_R, _BRIEF_R / np.maximum(r, 1e-9), 1.0)
        pts[:, k] *= f
        pts[:, k + 1] *= f
    return pts.astype(np.float64)


def _rotated_index_tables() -> np.ndarray:
    """(N_BINS, N_PAIRS, 2) flattened-patch indices of both taps of every
    pair, pre-rotated per orientation bin and rounded to the patch grid."""
    pat = _brief_pattern_clipped()
    out = np.zeros((N_BINS, N_PAIRS, 2), np.int64)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        ca, sa = np.cos(th), np.sin(th)
        for k, off in ((0, 0), (1, 2)):
            x = pat[:, off] * ca - pat[:, off + 1] * sa
            y = pat[:, off] * sa + pat[:, off + 1] * ca
            ix = np.clip(np.round(x).astype(np.int64) + PATCH_C, 0, PATCH - 1)
            iy = np.clip(np.round(y).astype(np.int64) + PATCH_C, 0, PATCH - 1)
            out[b, :, k] = iy * PATCH + ix
    return out


_IDX_TABLES = _rotated_index_tables()


def _ic_masks():
    """(PATCH, PATCH) moment kernels of the radius-15 IC-angle circle."""
    d = np.arange(PATCH) - PATCH_C
    dy, dx = np.meshgrid(d, d, indexing="ij")
    mask = (dx * dx + dy * dy) <= 15 * 15
    return (dx * mask).astype(np.float32), (dy * mask).astype(np.float32)


_MX, _MY = _ic_masks()


def _gather_patches(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(K, PATCH, PATCH) patches anchored at the rounded keypoint, the start
    clamped so the patch fits (lax.dynamic_slice semantics, C5)."""
    H, W = img.shape
    y0 = torch.clamp(torch.round(v).long() - PATCH_C, 0, H - PATCH)
    x0 = torch.clamp(torch.round(u).long() - PATCH_C, 0, W - PATCH)
    r = torch.arange(PATCH, device=img.device)
    idx = (y0[:, None, None] + r[None, :, None]) * W + (x0[:, None, None] + r[None, None, :])
    return img.reshape(-1)[idx]


def describe(img_blur: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Orientation + rBRIEF at (u, v) on the blurred image. Returns
    (desc (K, 8) int32, angle (K,))."""
    patches = _gather_patches(img_blur, u, v)
    dev = img_blur.device
    m10 = (patches * torch.as_tensor(_MX, device=dev)).sum(dim=(1, 2))
    m01 = (patches * torch.as_tensor(_MY, device=dev)).sum(dim=(1, 2))
    angle = torch.atan2(m01, m10)
    bin_ = torch.remainder(torch.round(angle * (N_BINS / (2.0 * np.pi))).long(), N_BINS)
    idx = torch.as_tensor(_IDX_TABLES, device=dev)[bin_]           # (K, 256, 2)
    flat = patches.reshape(patches.shape[0], PATCH * PATCH)
    taps = flat.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)
    return pack_bits(taps[..., 0] < taps[..., 1]), angle


def _level_capacities(capacity: int, n_levels: int, scale: float):
    """Per-level keypoint budget proportional to level area, summing to
    `capacity`."""
    inv = np.array([scale ** (-2.0 * lv) for lv in range(n_levels)])
    caps = np.floor(capacity * inv / inv.sum()).astype(int)
    caps[0] += capacity - caps.sum()
    return [int(c) for c in caps]


@functools.lru_cache(maxsize=64)
def _resize_weights(m: int, n: int) -> np.ndarray:
    """(m, n) float32 weights of an antialiased bilinear resize from m to n
    samples, computed as jax.image.resize computes them (triangle kernel
    widened by 1/scale when downsampling, columns normalized, samples
    outside the input zeroed)."""
    f32 = np.float32
    scale = f32(n / m)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(img: torch.Tensor, hl: int, wl: int) -> torch.Tensor:
    """jax.image.resize(img, (hl, wl), "bilinear") with its default
    antialiasing, as two matrix products (f32, TF32 off)."""
    H, W = img.shape
    out = img
    if hl != H:
        out = torch.as_tensor(_resize_weights(H, hl), device=img.device).T @ out
    if wl != W:
        out = out @ torch.as_tensor(_resize_weights(W, wl), device=img.device)
    return out


def level_image(img: torch.Tensor, lv: int, scale: float) -> torch.Tensor:
    """Level `lv` of the feature pyramid (level 0 is the image itself)."""
    if lv == 0:
        return img
    H, W = img.shape
    hl = max(int(round(H / scale ** lv)), PATCH + 2)
    wl = max(int(round(W / scale ** lv)), PATCH + 2)
    return resize_bilinear(img, hl, wl)


def extract_multiscale(img: torch.Tensor, n_levels: int, capacity: int,
                       fast_th: float, scale: float = 1.2, nms_cell: int = 8,
                       do_subpix: bool = False, use_fast_only: bool = False,
                       min_grad: float = 7.0):
    """Multi-scale FAST + oriented rBRIEF over a 1.2x feature pyramid.
    Returns (u, v, level, score, desc, valid) of fixed capacity, in level-0
    pixels. Unless `use_fast_only`, gradient-magnitude keypoints fill the
    cells where FAST fires nothing (FAST scores ride above them)."""
    caps = _level_capacities(capacity, n_levels, scale)
    us, vs, lvls, scs, descs, vals = [], [], [], [], [], []
    for lv in range(n_levels):
        lvl_img = level_image(img, lv, scale)
        hl, wl = lvl_img.shape
        score = fast_score(lvl_img, fast_th)
        if not use_fast_only:
            dx = 0.5 * (torch.roll(lvl_img, -1, 1) - torch.roll(lvl_img, 1, 1))
            dy = 0.5 * (torch.roll(lvl_img, -1, 0) - torch.roll(lvl_img, 1, 0))
            g2 = dx * dx + dy * dy
            grad_sc = torch.where(g2 > min_grad * min_grad, g2, torch.zeros_like(g2))
            score = torch.where(score > 0.0, score + 1e4, torch.clamp(grad_sc, max=9.9e3))
        score[:BORDER, :] = 0.0
        score[-BORDER:, :] = 0.0
        score[:, :BORDER] = 0.0
        score[:, -BORDER:] = 0.0
        u, v, valid = grid_nms(score, nms_cell, caps[lv])
        if do_subpix:
            u, v = subpix_refine(lvl_img, u, v)
        desc, _ = describe(gaussian_blur7(lvl_img), u, v)
        f = scale ** lv
        us.append(u * f)
        vs.append(v * f)
        lvls.append(torch.full((caps[lv],), lv, dtype=torch.int32, device=img.device))
        si = torch.clamp(v.long(), 0, hl - 1)
        sj = torch.clamp(u.long(), 0, wl - 1)
        scs.append(score[si, sj])
        descs.append(desc)
        vals.append(valid)
    return (torch.cat(us), torch.cat(vs), torch.cat(lvls), torch.cat(scs),
            torch.cat(descs), torch.cat(vals))


def subpix_refine(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  iters: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """cornerSubPix over a 3x3 window of bilinear gradients, one batched
    2x2 solve per iteration; corners with a singular structure tensor or
    more than 1.5 px of drift keep their integer location."""
    H, W = img.shape
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    d = torch.arange(-1.0, 2.0, device=img.device)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    ox = ox.reshape(-1)
    oy = oy.reshape(-1)
    c0 = torch.stack([u, v], -1)
    c = c0
    for _ in range(iters):
        qx = c[:, 0:1] + ox[None, :]
        qy = c[:, 1:2] + oy[None, :]
        gx = bilinear(dx, qx, qy)
        gy = bilinear(dy, qx, qy)
        a = (gx * gx).sum(-1)
        b = (gx * gy).sum(-1)
        cc = (gy * gy).sum(-1)
        bx = (gx * gx * qx + gx * gy * qy).sum(-1)
        by = (gx * gy * qx + gy * gy * qy).sum(-1)
        det = a * cc - b * b
        ok = det > 1e-8
        det = torch.where(ok, det, torch.ones_like(det))
        new = torch.stack([(cc * bx - b * by) / det, (a * by - b * bx) / det], -1)
        c = torch.where(ok[:, None], new, c)
    drift2 = ((c - c0) ** 2).sum(-1)
    good = (drift2 <= 1.5 ** 2) & torch.isfinite(c).all(-1)
    c = torch.where(good[:, None], c, c0)
    return torch.clamp(c[:, 0], 1.0, W - 2.0), torch.clamp(c[:, 1], 1.0, H - 2.0)


def features_in_area(f_u, f_v, f_valid, f_level, u, v, radius: float,
                     min_level: int = -1, max_level: int = 10_000) -> torch.Tensor:
    """GetFeaturesInArea as a dense (Q, NF) mask: keypoint j within `radius`
    of query i and inside the level band."""
    d2 = (u[:, None] - f_u[None, :]) ** 2 + (v[:, None] - f_v[None, :]) ** 2
    lv_ok = (f_level >= min_level) & (f_level <= max_level)
    return (d2 <= radius * radius) & f_valid[None, :] & lv_ok[None, :]


def match_pair(desc_a, valid_a, desc_b, valid_b, max_dist: int = 64,
               ratio: float = 0.8):
    """Mutual NN + Lowe ratio Hamming matching. desc_a/valid_a may carry a
    leading batch dimension (one keypoint set per window slot) against one
    set b. Returns (idx_b (..., Na), ok (..., Na))."""
    D = hamming_matrix(desc_a, desc_b)
    D = torch.where(valid_b[..., None, :], D, torch.full_like(D, BIG))
    D = torch.where(valid_a[..., :, None], D, torch.full_like(D, BIG))
    best, d1, d2, mutual = mutual_nn(D)
    ok = (d1 <= max_dist) & (d1 <= ratio * d2) & mutual & valid_a
    return best, ok
