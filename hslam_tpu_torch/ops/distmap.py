"""Half-resolution distance map for spatially spread point activation (port
of hslam_tpu/ops/distmap.py).

The same chamfer relaxation as the JAX package: `iterations` steps
alternating the 4- and 8-neighbourhood, each a min over shifted copies + 1.
The shifted mins are min-pools (max-pools of the negated map), whose
implicit padding never wins the min, exactly like the masked wrap-around
there. The fixed-count `fori_loop` is a Python loop with no host sync.
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

MAX_DIST = 1000.0


def _minpool(d, kh, kw):
    return -Fn.max_pool2d(-d[None, None], (kh, kw), stride=1,
                          padding=(kh // 2, kw // 2))[0, 0]


def distance_map(seed_u, seed_v, seed_valid, height: int, width: int,
                 iterations: int = 40) -> torch.Tensor:
    ui = torch.clamp(torch.round(seed_u).long(), 0, width - 1)
    vi = torch.clamp(torch.round(seed_v).long(), 0, height - 1)
    flat = torch.full((height * width,), MAX_DIST, dtype=torch.float32,
                      device=seed_u.device)
    vals = torch.where(seed_valid, torch.zeros_like(seed_u),
                       torch.full_like(seed_u, MAX_DIST))
    flat.scatter_reduce_(0, vi * width + ui, vals, reduce="amin")
    d = flat.reshape(height, width)
    for i in range(iterations):
        if i % 2 == 0:      # 4-neighbourhood
            nb = torch.minimum(_minpool(d, 3, 1), _minpool(d, 1, 3))
        else:               # 8-neighbourhood
            nb = _minpool(d, 3, 3)
        d = torch.minimum(d, nb + 1.0)
    return d
