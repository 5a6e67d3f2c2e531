"""The yardstick's peaks and the kernels' byte counts."""
from __future__ import annotations

# NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): HBM3 bandwidth
H100_HBM_BYTES_PER_S = 3.35e12


def pyramid_bytes(height: int, width: int, levels: int, in_itemsize: int) -> int:
    """Bytes the fused pyramid kernel must move for one frame: the input
    frame read once, and [I, dx, dy, |grad|^2] written once as float32 for
    every pixel of every level (level l is (height >> l, width >> l))."""
    out_pixels = sum((height >> lvl) * (width >> lvl) for lvl in range(levels))
    return height * width * in_itemsize + 16 * out_pixels
