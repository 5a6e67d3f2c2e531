"""ORB-style detection and binary descriptors (port of hslam_tpu/ops/orb.py):
dense FAST-9,16 response, grid non-max suppression, intensity-centroid
orientation, rotated BRIEF and Hamming matching.

Descriptor layout: the JAX package stores 256 bits as (N, 8) uint32. Torch
has little uint32 support and no popcount, so the port keeps the same 8
words with the same bits as int32 (a numpy `.view(np.int32)` of the JAX
array, see convert.py) and counts bits with a SWAR popcount on the int64
view of each pair of words. Hamming distances are therefore equal to the
JAX package's, not approximations of them.
"""
from __future__ import annotations

import numpy as np
import torch

_CIRCLE = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    dtype=np.int32,
)

BIG = 10_000          # distance given to invalid descriptors in matching


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9,16 response (H, W); 0 = not a corner. Score = sum of
    |I_circle - I_center| over the qualifying arc pixels."""
    circ = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1))
                        for dx, dy in _CIRCLE])                     # (16, H, W)
    diff = circ - img[None]
    brighter = diff > threshold
    darker = diff < -threshold

    def has_arc9(mask):
        m = torch.cat([mask, mask[:8]], dim=0)                      # (24, H, W)
        run = m[0:16]
        for k in range(1, 9):
            run = run & m[k:k + 16]
        return run.any(dim=0)

    is_corner = has_arc9(brighter) | has_arc9(darker)
    mag = torch.where(brighter | darker, diff.abs(), torch.zeros_like(diff)).sum(0)
    score = torch.where(is_corner, mag, torch.zeros_like(mag))
    # zero the border where the circle wraps
    score[:3, :] = 0.0
    score[-3:, :] = 0.0
    score[:, :3] = 0.0
    score[:, -3:] = 0.0
    return score


def grid_nms(score: torch.Tensor, cell: int, capacity: int,
             min_score: float = 1e-6):
    """Per-cell argmax then global top-k (the replacement for SSC's adaptive
    suppression). Returns (u, v, valid) of `capacity` keypoints."""
    H, W = score.shape
    Hp = (H + cell - 1) // cell * cell
    Wp = (W + cell - 1) // cell * cell
    s = torch.nn.functional.pad(score, (0, Wp - W, 0, Hp - H))
    hb, wb = Hp // cell, Wp // cell
    blocks = s.reshape(hb, cell, wb, cell).permute(0, 2, 1, 3).reshape(hb, wb, -1)
    best = blocks.amax(dim=-1)
    arg = blocks.argmax(dim=-1)          # the first maximum, as jnp.argmax
    by, bx = torch.div(arg, cell, rounding_mode="floor"), arg % cell
    dev = score.device
    ys = (torch.arange(hb, device=dev)[:, None] * cell + by).reshape(-1)
    xs = (torch.arange(wb, device=dev)[None, :] * cell + bx).reshape(-1)
    vals = best.reshape(-1)
    k = min(capacity, vals.shape[0])
    # lax.top_k: the k largest, ties in index order (a stable sort; C4)
    top_vals, top_idx = torch.sort(vals, descending=True, stable=True)
    top_vals, top_idx = top_vals[:k], top_idx[:k]
    u = xs[top_idx].float()
    v = ys[top_idx].float()
    valid = top_vals > min_score
    if k < capacity:
        pad = capacity - k
        u = torch.cat([u, torch.zeros(pad, device=dev)])
        v = torch.cat([v, torch.zeros(pad, device=dev)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
    return u, v, valid


_PATCH_R = 15  # IC_Angle half patch size


def ic_angle(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (N,) in radians, batched."""
    H, W = img.shape
    d = torch.arange(-_PATCH_R, _PATCH_R + 1, device=img.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")                    # (31, 31)
    mask = (dx * dx + dy * dy) <= _PATCH_R * _PATCH_R
    ui = torch.clamp(torch.round(u).long(), _PATCH_R, W - _PATCH_R - 1)
    vi = torch.clamp(torch.round(v).long(), _PATCH_R, H - _PATCH_R - 1)
    ys = vi[:, None, None] + dy[None]
    xs = ui[:, None, None] + dx[None]
    vals = img.reshape(-1)[ys * W + xs] * mask[None]
    m10 = (vals * dx[None]).sum(dim=(1, 2))
    m01 = (vals * dy[None]).sum(dim=(1, 2))
    return torch.atan2(m01, m10)


def _brief_pattern(n_pairs: int = 256, patch: int = 31, seed: int = 42) -> np.ndarray:
    """(n_pairs, 4) [x1, y1, x2, y2] Gaussian test pairs, sigma = patch/5
    (the JAX package's numpy RandomState(42) construction, copied)."""
    rng = np.random.RandomState(seed)
    sigma = patch / 5.0
    lim = patch // 2 - 1
    pts = np.clip(rng.randn(n_pairs, 4) * sigma, -lim, lim)
    return pts.astype(np.float32)


_PATTERN256 = _brief_pattern()


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32, bit k of word w = test 32 w + k (the
    JAX package's uint32 words, reinterpreted)."""
    w = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    w = torch.where(w >= 2 ** 31, w - 2 ** 32, w)          # bit 31 as int32
    words = (bits.reshape(-1, 8, 32).long() * w).sum(-1)
    return words.to(torch.int32)


def rbrief(img_blur: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           angle: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF descriptors (N, 8) int32 (256 bits) with bilinear taps
    clamped into the image as in the JAX package."""
    H, W = img_blur.shape
    pat = torch.as_tensor(_PATTERN256, device=img_blur.device)
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]

    def rot(x, y):
        return (ca * x[None] - sa * y[None] + u[:, None],
                sa * x[None] + ca * y[None] + v[:, None])

    x1, y1 = rot(pat[:, 0], pat[:, 1])
    x2, y2 = rot(pat[:, 2], pat[:, 3])
    flat = img_blur.reshape(-1)

    def sample(x, y):
        xc = torch.clamp(x, 0.0, W - 1.0)
        yc = torch.clamp(y, 0.0, H - 1.0)
        ix = torch.clamp(torch.floor(xc).long(), 0, W - 2)
        iy = torch.clamp(torch.floor(yc).long(), 0, H - 2)
        fx = xc - ix.float()
        fy = yc - iy.float()
        base = iy * W + ix
        return ((flat[base] * (1 - fx) + flat[base + 1] * fx) * (1 - fy)
                + (flat[base + W] * (1 - fx) + flat[base + W + 1] * fx) * fy)

    return pack_bits(sample(x1, y1) < sample(x2, y2))


_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bits set per int64 element. Shifts are arithmetic in torch; every
    mask clears the sign-extended bits, and from the nibble sums on the
    value is non-negative, so the byte sums below cannot overflow."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(..., Na, 8) x (..., Nb, 8) int32 -> (..., Na, Nb) int32 Hamming
    distances."""
    a = da.contiguous().view(torch.int64)                  # (..., Na, 4)
    b = db.contiguous().view(torch.int64)
    x = a[..., :, None, :] ^ b[..., None, :, :]
    return _popcount64(x).sum(-1).to(torch.int32)


def mutual_nn(D: torch.Tensor):
    """Best match per row, its distance, the second-best distance and the
    mutual-nearest check of a (..., Na, Nb) distance matrix (the shared core
    of match_descriptors and features.match_pair; argmin takes the first
    minimum, as jnp.argmin)."""
    best = D.argmin(dim=-1)
    d1 = D.gather(-1, best[..., None])[..., 0]
    D2 = D.scatter(-1, best[..., None], BIG)
    d2 = D2.min(dim=-1).values
    back = D.argmin(dim=-2)
    ar = torch.arange(D.shape[-2], device=D.device)
    mutual = back.gather(-1, best) == ar
    return best, d1, d2, mutual


def match_descriptors(da, db, max_dist: int = 50, ratio: float = 0.9,
                      valid_a=None, valid_b=None):
    """Mutual nearest neighbour with Lowe's ratio test. Returns (idx_b (Na,),
    ok (Na,))."""
    D = hamming_matrix(da, db)
    if valid_b is not None:
        D = torch.where(valid_b[None, :], D, torch.full_like(D, BIG))
    best, d1, d2, mutual = mutual_nn(D)
    ok = (d1 <= max_dist) & (d1 <= ratio * d2) & mutual
    if valid_a is not None:
        ok = ok & valid_a
    return best, ok
