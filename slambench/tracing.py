"""The traced run's instruments, all in the benchmark's own files.

- Spans: `wrapped(...)` replaces module or class attributes of the program
  by wrappers that time each outermost call on the host clock and
  synchronise the card at its end, and puts every original back on exit.
  The untraced run installs none of them.
- Counters and latency records: system attributes read at the window's
  open and close; a bounded deque of the system is swapped for an unbounded
  one for the window, and the original put back.
- The device: `torch.profiler` (CUDA activity only) over a stretch of
  steady frames inside the window, reduced to busy and idle time, the time
  of each kernel, the top device operations and the longest idle gaps,
  each named by the host spans open across it.
Spans are kept in memory; the harness reduces them when the run ends.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


class Span(NamedTuple):
    name: str
    thread: int
    t0: float
    t1: float


class Spans:
    """Spans kept in memory (list.append is atomic under the GIL)."""

    def __init__(self):
        self.items: List[Span] = []
        self._tls = threading.local()

    def add(self, name, t0, t1):
        self.items.append(Span(name, threading.get_ident(), t0, t1))

    def of(self, name) -> List[Span]:
        return [s for s in self.items if s.name == name]

    def wrapper(self, fn, name, sync):
        """fn timed as span `name`; a call inside another call of the same
        name (track_step calls track_coarse_multi) is not timed again."""
        tls = self._tls

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            depth = getattr(tls, name, 0)
            if depth:
                return fn(*args, **kwargs)
            setattr(tls, name, 1)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync()
                self.add(name, t0, time.perf_counter())
                setattr(tls, name, 0)
        return timed


def _resolve(target: str):
    """'package.module:Attr' or 'package.module:Class.method' -> (owner,
    attribute name)."""
    mod_name, path = target.split(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


@contextlib.contextmanager
def wrapped(targets: Dict[str, str], spans: Spans, sync):
    """Wrap every target ('module:attr' -> span name) for the block; the
    originals go back on exit, whatever happens."""
    saved = []
    try:
        for target, name in targets.items():
            owner, attr = _resolve(target)
            orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            saved.append((owner, attr, orig))
            setattr(owner, attr, spans.wrapper(getattr(owner, attr), name, sync))
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


@contextlib.contextmanager
def unbounded(system, names):
    """Swap each bounded deque attribute of `system` for an unbounded one
    for the block; yields {name: the list of entries added}."""
    saved = {n: getattr(system, n) for n in names}
    got: Dict[str, list] = {}
    for n in names:
        setattr(system, n, collections.deque())
    try:
        yield got
    finally:
        for n in names:
            got[n] = list(getattr(system, n))
            setattr(system, n, saved[n])


class DeviceTrace(NamedTuple):
    window_s: float                        # the profiled stretch
    busy_s: float                          # union of device activity in it
    kernels: List[Tuple[str, float, float]]   # (name, start, duration), host seconds
    gaps: List[Tuple[str, float]]          # (open host spans, seconds), longest first
    top_ops: List[Tuple[str, float]]       # (name, total seconds), largest first


class Profiler:
    """torch.profiler over a stretch of the window, opened and closed by
    the harness between two frames."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        # the trace's clock is the epoch's; spans use perf_counter
        self.offset = time.time() - time.perf_counter()

    def stop(self):
        if self.prof is None or self.t1 is not None:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reduce(self, spans: Spans) -> Optional[DeviceTrace]:
        if self.prof is None or self.t1 is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        ivals = []
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = e.start_ns() * 1e-9 - self.offset
            d = e.duration_ns() * 1e-9
            if e.is_user_annotation() or d <= 0:
                continue
            ivals.append((e.name(), s, d))
        ivals.sort(key=lambda x: x[1])
        lo, hi = self.t0, self.t1
        busy, gaps, cur_s, cur_e = 0.0, [], None, lo
        for _, s, d in ivals:
            s, e = max(s, lo), min(s + d, hi)
            if e <= s:
                continue
            if s > cur_e:
                gaps.append((cur_e, s))
                if cur_s is not None:
                    busy += cur_e - cur_s
                cur_s = s
            elif cur_s is None:
                cur_s = s
            cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        if hi > cur_e:
            gaps.append((cur_e, hi))
        tot: Dict[str, float] = collections.defaultdict(float)
        for name, _, d in ivals:
            tot[name[:160]] += d
        top = sorted(tot.items(), key=lambda x: -x[1])[:10]
        named = sorted(((_open_at(spans, 0.5 * (a + b)), b - a) for a, b in gaps),
                       key=lambda x: -x[1])[:10]
        return DeviceTrace(hi - lo, busy, ivals, named, top)


def _open_at(spans: Spans, t: float) -> str:
    names = sorted({s.name for s in spans.items if s.t0 <= t <= s.t1})
    return "+".join(names) if names else "host"
