"""Camera calibration state (port of hslam_tpu/models/calib.py).

value = [fx, fy, cx, cy] at pyramid level 0; value_zero is the FEJ copy.
Per-level intrinsics halve per level with the 0.5-pixel-center convention
(reference CalibData.h:142-168).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Calib(NamedTuple):
    value: torch.Tensor        # (4,) current estimate
    value_zero: torch.Tensor   # (4,) FEJ linearization point
    width: int
    height: int

    def delta(self):
        return self.value - self.value_zero


def make_calib(fx, fy, cx, cy, width, height, device="cuda") -> Calib:
    v = torch.tensor([fx, fy, cx, cy], dtype=torch.float32, device=device)
    return Calib(value=v, value_zero=v.clone(), width=int(width),
                 height=int(height))


def level_intrinsics(calib: Calib, level: int) -> torch.Tensor:
    """(4,) [fx, fy, cx, cy] at a pyramid level."""
    s = 0.5 ** level
    v = calib.value
    return torch.stack([v[0] * s, v[1] * s, (v[2] + 0.5) * s - 0.5,
                        (v[3] + 0.5) * s - 0.5])


def k_pyr_from_value(value: torch.Tensor, n_levels: int) -> torch.Tensor:
    """(L, 4) per-level intrinsics from a (4,) level-0 vector."""
    s = 0.5 ** torch.arange(n_levels, dtype=torch.float32, device=value.device)
    return torch.stack([value[0] * s, value[1] * s, (value[2] + 0.5) * s - 0.5,
                        (value[3] + 0.5) * s - 0.5], dim=-1)
