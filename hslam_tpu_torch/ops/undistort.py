"""Per-frame image correction (port of hslam_tpu/ops/undistort.py).

  * Geometric undistortion: a precomputed remap table applied as one
    bilinear gather, the equivalent of the reference's cv::remap call
    (Src/GeometricUndistorter.cpp:458-475).
  * Photometric undistortion: inverse-response LUT and inverse vignette,
    I' = Binv[I] * Vinv; the exposure division is left to the affine
    brightness model downstream (Src/PhotometricDistorter/
    photometricUndistorter.cpp:121-146).

Plain torch on whatever device the tensors are on: elementwise passes and
one gather, once per input frame.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.interp import bilinear


def remap_image(img: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """img (H_in, W_in); remap (H_out, W_out, 2) of (x, y) source coords,
    -1 marks invalid (output set to 0)."""
    x = remap[..., 0]
    y = remap[..., 1]
    out = bilinear(img, x, y)
    return torch.where(x < 0, torch.zeros_like(out), out)


def photometric_correct(raw: torch.Tensor, inv_response: Optional[torch.Tensor],
                        inv_vignette: Optional[torch.Tensor]) -> torch.Tensor:
    """I' = Binv[I] * Vinv (photometricUndistorter.cpp:121-146). `raw`: (H, W)
    raw 8-bit intensities as float; `inv_response`: (256,) Binv LUT;
    `inv_vignette`: (H, W) 1/V map. The LUT is interpolated between
    entries; intensities outside [0, 255] take the end entries."""
    out = raw
    if inv_response is not None:
        idx = torch.clamp(raw.to(torch.int32), 0, 255).long()
        frac = torch.clamp(raw - idx.to(raw.dtype), 0.0, 1.0)
        lo = inv_response[idx]
        hi = inv_response[torch.clamp(idx + 1, max=255)]
        out = lo * (1.0 - frac) + hi * frac
    if inv_vignette is not None:
        out = out * inv_vignette
    return out


def invert_response(gamma: torch.Tensor) -> torch.Tensor:
    """Numerically invert a monotone response curve G: [0..255] -> [0..255]
    (UpdateGamma, photometricUndistorter.cpp:175-200): Binv[i] is the x with
    G(x) = i, by a left-side search and linear interpolation."""
    G = gamma.contiguous()
    xs = torch.arange(256, dtype=G.dtype, device=G.device)
    idx = torch.clamp(torch.searchsorted(G, xs) - 1, 0, 254)
    g0 = G[idx]
    g1 = G[idx + 1]
    frac = torch.where(g1 > g0, (xs - g0) / torch.clamp(g1 - g0, min=1e-12),
                       torch.zeros_like(xs))
    return torch.clamp(idx.to(G.dtype) + frac, 0.0, 255.0)


def response_grad_weight(gamma: torch.Tensor) -> torch.Tensor:
    """(256,) weight B'(I) that re-weights gradients in the pyramid build
    (getBGradOnly, photometricUndistorter.h:24-31; used Frame.cpp:158-164)."""
    d = gamma[1:] - gamma[:-1]
    return torch.cat([d, d[-1:]])
