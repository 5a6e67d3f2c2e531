"""Gradient-based candidate pixel selection (port of
hslam_tpu/ops/selector.py).

Per-32x32-block gradient-histogram thresholds, then hierarchical masked
block-argmax picks at block sizes pot, 2 pot and 4 pot, each block scored
by the projection of the gradient on a per-block pseudo-random direction.

Random draws (C3): the JAX package draws the block directions with
jax.random.randint (selector.py:156-158) and the subsampling uniforms with
jax.random.uniform (:217-218); torch cannot reproduce those bits. Each
function here takes the draws as an optional argument (tests pass the JAX
draws in); otherwise it draws from a torch.Generator seeded from the same
(salt, seed) pair the JAX key is folded from.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..config import Config

_DIRECTIONS = [
    [0, 1.0000], [0.3827, 0.9239], [0.1951, 0.9808], [0.9239, 0.3827],
    [0.7071, 0.7071], [0.3827, -0.9239], [0.8315, 0.5556], [0.8315, -0.5556],
    [0.5556, -0.8315], [0.9808, 0.1951], [0.9239, -0.3827], [0.7071, -0.7071],
    [0.5556, 0.8315], [0.9808, -0.1951], [1.0000, 0.0000], [0.1951, -0.9808],
]


def _generator(device, key0: int, salt: int, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((key0 * 1_000_003 + salt) * 1_000_003 + int(seed))
    return g


def block_thresholds(abs_grad0: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Per-32x32-block smoothed squared threshold (makeHists)."""
    H, W = abs_grad0.shape
    h32, w32 = H // 32, W // 32
    dev = abs_grad0.device
    g = torch.clamp(torch.sqrt(torch.clamp(abs_grad0, min=0.0)), 0.0, 48.0).to(torch.int64)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    valid = (xs >= 1) & (xs <= W - 2) & (ys >= 1) & (ys <= H - 2)
    gb = g[: h32 * 32, : w32 * 32]
    vb = valid[: h32 * 32, : w32 * 32]
    blk = (ys[: h32 * 32] // 32) * w32 + xs[:, : w32 * 32] // 32
    hist = torch.zeros(h32 * w32 * 49, dtype=torch.float32, device=dev)
    hist.index_add_(0, (blk * 49 + gb).reshape(-1), vb.reshape(-1).float())
    hist = hist.reshape(h32, w32, 49)
    total = hist.sum(-1)
    csum = torch.cumsum(hist, dim=-1)
    below = csum < (cfg.min_grad_hist_cut * total)[..., None]
    ths = below.sum(-1).float() + cfg.min_grad_hist_add

    padded = torch.nn.functional.pad(ths, (1, 1, 1, 1))
    cnt = torch.nn.functional.pad(torch.ones_like(ths), (1, 1, 1, 1))
    ssum = torch.zeros_like(ths)
    snum = torch.zeros_like(ths)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ssum = ssum + padded[1 + dy: 1 + dy + h32, 1 + dx: 1 + dx + w32]
            snum = snum + cnt[1 + dy: 1 + dy + h32, 1 + dx: 1 + dx + w32]
    sm = ssum / snum
    return sm * sm


def _block_best(score: torch.Tensor, blk: int):
    H, W = score.shape
    hb, wb = H // blk, W // blk
    s = score.reshape(hb, blk, wb, blk).permute(0, 2, 1, 3).reshape(hb, wb, blk * blk)
    best, arg = s.max(dim=-1)
    by = torch.div(arg, blk, rounding_mode="floor")
    bx = arg % blk
    ys = torch.arange(hb, device=score.device)[:, None] * blk + by
    xs = torch.arange(wb, device=score.device)[None, :] * blk + bx
    return best, ys * W + xs


def direction_draws(H: int, W: int, pot: int, seed: int, device) -> List[torch.Tensor]:
    """Per-block direction indices in [0, 16) for the three tiers."""
    blk4 = 4 * pot
    Hp = ((H + blk4 - 1) // blk4) * blk4
    Wp = ((W + blk4 - 1) // blk4) * blk4
    out = []
    for salt, blk in enumerate((pot, 2 * pot, 4 * pot)):
        g = _generator(device, 0, salt, seed)
        out.append(torch.randint(0, 16, (Hp // blk, Wp // blk), generator=g, device=device))
    return out


def select_pixels(dir_img0: torch.Tensor, abs_grad: Tuple[torch.Tensor, ...],
                  pot: int, th_factor: float, seed: int, cfg: Config,
                  dir_idx: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Dense (H, W) int32 status map in {0, 1, 2, 4}."""
    H, W = abs_grad[0].shape
    dev = abs_grad[0].device
    blk4 = 4 * pot
    Hp = ((H + blk4 - 1) // blk4) * blk4
    Wp = ((W + blk4 - 1) // blk4) * blk4
    if dir_idx is None:
        dir_idx = direction_draws(H, W, pot, seed, dev)
    dirs_tbl = torch.tensor(_DIRECTIONS, dtype=torch.float32, device=dev)

    ths = block_thresholds(abs_grad[0], cfg)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)

    def _up(a, f):
        """Nearest-neighbour upsample by f, edge-extended to (H, W)."""
        yi = torch.clamp(torch.div(ys, f, rounding_mode="floor"), max=a.shape[0] - 1)
        xi = torch.clamp(torch.div(xs, f, rounding_mode="floor"), max=a.shape[1] - 1)
        return a[yi][:, xi]

    th0 = _up(ths, 32)
    dw1 = cfg.grad_downweight_per_level
    dw2 = dw1 * dw1
    border = ((xs[None, :] >= 4) & (xs[None, :] < W - 5)
              & (ys[:, None] >= 4) & (ys[:, None] < H - 4))
    ag0 = abs_grad[0]
    ag1 = _up(abs_grad[1], 2)
    ag2 = _up(abs_grad[2], 4)
    pass0 = (ag0 > th0 * th_factor) & border
    pass1 = (ag1 > th0 * dw1 * th_factor) & border
    pass2 = (ag2 > th0 * dw2 * th_factor) & border
    grad = dir_img0[..., 1:3]
    ninf = float("-inf")

    def dir_score(blk, idx, mask):
        d = dirs_tbl[idx]
        dfull = d.repeat_interleave(blk, 0).repeat_interleave(blk, 1)[:H, :W]
        if cfg.select_direction_distribution:
            s = torch.abs(torch.sum(grad * dfull, dim=-1))
        else:
            s = ag0
        s = torch.where(mask, s, torch.full_like(s, ninf))
        return torch.nn.functional.pad(s, (0, Wp - W, 0, Hp - H), value=ninf)

    best0, idx0 = _block_best(dir_score(pot, dir_idx[0], pass0), pot)
    sel0 = best0 > ninf
    best1, idx1 = _block_best(dir_score(2 * pot, dir_idx[1], pass1), 2 * pot)
    h0, w0 = sel0.shape
    sel0_2 = sel0.reshape(h0 // 2, 2, w0 // 2, 2).any(3).any(1)
    sel1 = (best1 > ninf) & ~sel0_2
    best2, idx2 = _block_best(dir_score(4 * pot, dir_idx[2], pass2), 4 * pot)
    sel01_4 = (sel0.reshape(h0 // 4, 4, w0 // 4, 4).any(3).any(1)
               | sel1.reshape(h0 // 4, 2, w0 // 4, 2).any(3).any(1))
    sel2 = (best2 > ninf) & ~sel01_4

    status = torch.zeros(Hp * Wp, dtype=torch.int32, device=dev)
    for idx, sel, val in ((idx0, sel0, 1), (idx1, sel1, 2), (idx2, sel2, 4)):
        v = torch.where(sel.reshape(-1), val, 0).to(torch.int32)
        status.scatter_reduce_(0, idx.reshape(-1), v, reduce="amax")
    return status.reshape(Hp, Wp)[:H, :W]


def compact_selection(status: torch.Tensor, abs_grad0: torch.Tensor,
                      capacity: int, want: int, seed: int,
                      rand: Optional[torch.Tensor] = None):
    """Dense map -> fixed-capacity list (u, v, type, valid). Above `want`
    picks a random subset of ~want survives (PixelSelector.cpp:148-176).
    Ranking ties keep index order (lax.top_k's order)."""
    H, W = status.shape
    flat_status = status.reshape(-1)
    n_sel = (flat_status > 0).sum()
    keep_prob = torch.clamp(want / torch.clamp(n_sel, min=1).float(), max=1.0)
    if rand is None:
        g = _generator(status.device, 17, 0, seed)
        rand = torch.rand(flat_status.shape, generator=g, device=status.device)
    keep = (flat_status > 0) & (rand < keep_prob)
    score = torch.where(keep, abs_grad0.reshape(-1),
                        torch.full_like(abs_grad0.reshape(-1), float("-inf")))
    top_v, top_i = torch.sort(score, descending=True, stable=True)
    cap = min(capacity, score.shape[0])
    idx = top_i[:cap]
    valid = top_v[:cap] > float("-inf")
    return ((idx % W).float(), torch.div(idx, W, rounding_mode="floor").float(),
            flat_status[idx], valid)
