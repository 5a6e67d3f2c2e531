"""Robust loss utilities (port of hslam_tpu/utils/robust.py, on tensors).

Reproduces the reference's Huber handling (Src/OptimizationClasses.cpp:166-171,
Src/CoarseTracker.cpp calcRes): for residual r and threshold k,
  hw     = 1 if |r| < k else k/|r|
  energy = hw * r^2 * (2 - hw)      (the exact DSO energy form)
  IRLS weight applied to J and r: sqrt(hw) if hw < 1 else hw ( == hw after
  the reference's `if (hw < 1) hw = sqrtf(hw)` since hw <= 1 always).
"""
from __future__ import annotations

import torch


def huber_weight(r, k):
    """hw in (0, 1]: 1 inside the inlier region, k/|r| outside."""
    a = torch.abs(r)
    return torch.where(a < k, torch.ones_like(a), k / torch.clamp(a, min=1e-12))


def huber_energy(r, k):
    """DSO-form robust energy: hw * r^2 * (2 - hw)."""
    hw = huber_weight(r, k)
    return hw * r * r * (2.0 - hw)


def huber_irls_weight(r, k):
    """Multiplier applied to J and r when forming the GN system: sqrt(hw)
    clamped as in the reference (`if (hw < 1) hw = sqrtf(hw)`)."""
    hw = huber_weight(r, k)
    return torch.where(hw < 1.0, torch.sqrt(hw), hw)


def gradient_weight(gx, gy, c):
    """Gradient-dependent down-weighting, reference OptimizationClasses.cpp:163:
    sqrt(c / (c + |grad|^2)) with c = setting_outlierTHSumComponent."""
    return torch.sqrt(c / (c + gx * gx + gy * gy))
