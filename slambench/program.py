"""The program's own spans and counters (hslam_tpu_torch/utils/trace.py),
for the per-layer metrics whose SOURCE is {"program": {"spans": [...],
"counters": [...]}}.

With --trace 1 and such a metric in the cell, run.py calls `start()` just
before it builds the system, so the tracer records the bootstrap, the
warm-up and the window, and `stop()` in a `finally` when the window closes,
and again on its way out, so a run that fails, also before its system
exists, leaves the tracer off. An untraced run records nothing.

Phases, on the clock the harness stamps its spans on (perf_counter):
- the window: spans that start at or after the window's first frame (the
  harness's first `rectify` span) and end before the profiled stretch (as
  `TraceData.span_ms` reads the harness's spans) and the window's last
  `entry` span;
- set-up: spans that end before the window's first frame.
A counter's window delta is the sum of the counts each window `frame` span
(a root span of the thread that calls the entry) made while it was open.

Without the tracer (a checkout older than it) `start()` and `stop()` do
nothing and every reading is None.
"""
from __future__ import annotations

import importlib
import math
import sys
from typing import List, Optional

from slambench.tracing import _open_at


def _tracer():
    try:
        return importlib.import_module("hslam_tpu_torch.utils.trace")
    except ImportError:
        return None


def start() -> None:
    """Turn the program's tracer on with an empty record."""
    tr = _tracer()
    if tr is not None:
        tr.enable()


def stop() -> None:
    """Turn the program's tracer off; its record stays for `reading`."""
    tr = _tracer()
    if tr is not None:
        tr.disable()


def self_ns(parent, children) -> int:
    """The parent span's length less the union of its children's
    intervals (clipped to the parent's), in ns."""
    ivals = sorted((max(c.t0, parent.t0), min(c.t1, parent.t1)) for c in children)
    covered, cur_s, cur_e = 0, None, None
    for s, e in ivals:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return (parent.t1 - parent.t0) - covered


class Reading:
    """One run's record of the program, split into its phases."""

    def __init__(self, snap: dict, open_s: float, close_s: float, thread: Optional[int]):
        self.spans = [s for s in snap["spans"] if s.t1 is not None]
        self.all = snap["spans"]
        self.open_ns = open_s * 1e9
        self.close_ns = close_s * 1e9
        self.thread = thread
        self.frames = [s for s in self.of("frame", "window")
                       if s.parent is None and (thread is None or s.thread == thread)]

    def of(self, name: str, phase: str) -> list:
        """The closed spans of `name` in the phase ("setup" or "window")."""
        if phase == "setup":
            return [s for s in self.spans if s.name == name and s.t1 < self.open_ns]
        if phase == "window":
            return [s for s in self.spans if s.name == name
                    and s.t0 >= self.open_ns and s.t1 < self.close_ns]
        raise ValueError(f"no phase {phase!r}")

    def counter_delta(self, name: str) -> int:
        return sum((s.counts or {}).get(name, 0) for s in self.frames)

    def mean_self_ms(self) -> Optional[float]:
        """Mean over the window's frames of their self time, ms."""
        if not self.frames:
            return None
        index = {id(s): i for i, s in enumerate(self.all)}
        kids: dict = {}
        for s in self.spans:
            if s.parent is not None:
                kids.setdefault(s.parent, []).append(s)
        tot = sum(self_ns(f, kids.get(index[id(f)], [])) for f in self.frames)
        return 1e-6 * tot / len(self.frames)

    def path_at(self, t_ns: float) -> Optional[str]:
        """The innermost span open at t_ns on the entry's thread, as the path
        of names from its root ("frame>track>track.level")."""
        open_ = [i for i, s in enumerate(self.all)
                 if s.thread == self.thread and s.t0 <= t_ns and (s.t1 is None or t_ns <= s.t1)]
        if not open_:
            return None
        i, names = max(open_, key=lambda k: self.all[k].t0), []
        while i is not None:
            names.append(self.all[i].name)
            i = self.all[i].parent
        return ">".join(reversed(names))


def reading(run) -> Optional[Reading]:
    """The run's Reading (made once, on the first call), or None without a
    tracer or a window."""
    if hasattr(run, "_program_reading"):
        return run._program_reading
    tr, got = _tracer(), None
    rect, entry = run.spans.of("rectify"), run.spans.of("entry")
    if tr is not None and rect and entry:
        got = Reading(tr.snapshot(), min(s.t0 for s in rect),
                      min(max(s.t1 for s in entry), run.profiled_from), entry[0].thread)
        for name, secs in named_gaps(run, got):
            print(f"[gaps] {secs:.6f} s {name}", file=sys.stderr, flush=True)
    run._program_reading = got
    return got


def named_gaps(run, got: Reading, top: int = 10) -> List[tuple]:
    """The profiled stretch's longest idle gaps, as the harness finds them
    (tracing.Profiler.reduce), each named by the harness's spans open at its
    midpoint and, after "|", the program's span path open there on the
    thread that called the entry. [] without a profiled stretch."""
    dev = run.device
    if dev is None or not math.isfinite(run.profiled_from):
        return []
    lo, hi = run.profiled_from, run.profiled_from + dev.window_s
    gaps, cur_e = [], lo
    for _, s, d in sorted(dev.kernels, key=lambda x: x[1]):
        s, e = max(s, lo), min(s + d, hi)
        if e <= s:
            continue
        if s > cur_e:
            gaps.append((cur_e, s))
        cur_e = max(cur_e, e)
    if hi > cur_e:
        gaps.append((cur_e, hi))
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (a + b)
        path = got.path_at(mid * 1e9)
        name = _open_at(run.spans, mid)
        out.append((name if path is None else f"{name}|{path}", b - a))
    return out
