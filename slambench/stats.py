"""The end-to-end arithmetic of a window."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def window_metrics(handed: Sequence[float], returned: Sequence[float], t0: float, t_end: float):
    """fps and frame_ms_p95 of a window that opened at t0 and closed at
    t_end (host seconds, the card synchronised): `handed[i]` and
    `returned[i]` are when frame i was handed over and when the call that
    gave back its pose returned, for every frame completed in the window.
    The percentile is linear between order statistics (numpy's default)."""
    lat_ms = [1e3 * (r - h) for h, r in zip(handed, returned)]
    return dict(fps=len(lat_ms) / (t_end - t0), frame_ms_p95=float(np.percentile(lat_ms, 95)),
                n=len(lat_ms))
