"""Debug image rendering: the 2D observability surface (port of
hslam_tpu/viz/debug_draw.py; cv2 on the host).

Replaces the reference GUI's current-frame view (Src/Display.cpp 2D panel:
keypoints over the live frame) and the inverse-depth template
visualization with PNG artifacts writable from any run.
"""
from __future__ import annotations

import numpy as np


def _colormap_idepth(idepth: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Map inverse depth to a BGR jet-ish colormap; invalid -> black."""
    vals = idepth[valid]
    if vals.size == 0:
        return np.zeros(idepth.shape + (3,), np.uint8)
    lo, hi = np.percentile(vals, 5), np.percentile(vals, 95)
    t = np.clip((idepth - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    img = (np.stack([b, g, r], -1) * 255).astype(np.uint8)
    img[~valid] = 0
    return img


def draw_frame(image: np.ndarray, points_uv: np.ndarray | None = None,
               candidates_uv: np.ndarray | None = None) -> np.ndarray:
    """Grayscale frame -> BGR with active points (green) and candidates
    (blue) marked."""
    import cv2

    img8 = np.clip(image, 0, 255).astype(np.uint8)
    out = cv2.cvtColor(img8, cv2.COLOR_GRAY2BGR)
    if candidates_uv is not None:
        for u, v in candidates_uv:
            cv2.circle(out, (int(u), int(v)), 1, (255, 128, 0), -1)
    if points_uv is not None:
        for u, v in points_uv:
            cv2.circle(out, (int(u), int(v)), 2, (0, 255, 0), -1)
    return out


def draw_template_depth(image: np.ndarray, tmpl_u, tmpl_v, tmpl_idepth,
                        tmpl_valid) -> np.ndarray:
    """Reference-style inverse-depth overlay of the tracker template (host
    arrays: numpy, or tensors on the CPU)."""
    import cv2

    img8 = np.clip(image, 0, 255).astype(np.uint8)
    out = cv2.cvtColor(img8, cv2.COLOR_GRAY2BGR)
    u = np.asarray(tmpl_u)
    v = np.asarray(tmpl_v)
    idp = np.asarray(tmpl_idepth)
    ok = np.asarray(tmpl_valid)
    if ok.sum() == 0:
        return out
    lo, hi = np.percentile(idp[ok], 5), np.percentile(idp[ok], 95)
    for i in np.where(ok)[0]:
        t = float(np.clip((idp[i] - lo) / max(hi - lo, 1e-6), 0, 1))
        color = (int(255 * (1 - t)), int(255 * min(2 * t, 2 - 2 * t)), int(255 * t))
        cv2.circle(out, (int(u[i]), int(v[i])), 1, color, -1)
    return out


def save_debug_frame(path: str, system, image: np.ndarray):
    """One-call debug artifact from a live SLAMSystem: the tracker
    template's inverse depths over `image`, or the bare frame before the
    first template. The template's finest level is copied to the host."""
    import cv2

    tpl = system.template
    if tpl is not None:
        out = draw_template_depth(
            image, *(x[0].cpu().numpy() for x in (tpl.u, tpl.v, tpl.idepth, tpl.valid)))
    else:
        out = draw_frame(image)
    if not cv2.imwrite(path, out):
        raise OSError(f"cv2.imwrite could not write {path}")
