"""The port's spans and counters: where the host spends a frame, on which
thread, and how often it waits for the card.

Off by default. While off, `span()` returns one shared no-op object and
`count()` returns after one flag test: no clock is read, no lock is taken
and nothing is kept. `enable()` starts a new record; `snapshot()` returns
what was recorded since.

A span records its name, its start and end on `time.perf_counter_ns()`,
the thread that ran it, the index of the span it ran inside on the same
thread (None for a root), the frame it works on (`Shell.id`: given where
the work names its shell, else inherited from the enclosing span) and
attributes. A root span also keeps the counts its thread made while it was
open, so a reader can attribute counts to the frames it selects.

The tracer never waits for the card. A span ends where the program's own
code ends: where that is a host sync, the span times the card's work;
elsewhere it times the host's enqueue of it.

Counters are totals by name. Each thread counts into a dict of its own;
`snapshot()` sums them, so no count is lost between the tracking thread,
the mapping thread and the loop-closure worker.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

_on = False
_lock = threading.Lock()      # guards _threads and _gen
_gen = 0                      # the record's number; enable() starts a new one
_threads: list = []           # _Thread of every thread that recorded since enable()
_tls = threading.local()


class SpanRecord(NamedTuple):
    name: str
    t0: int                   # perf_counter_ns at the start
    t1: Optional[int]         # perf_counter_ns at the end; None while open
    thread: int               # threading.get_ident() of the thread that ran it
    thread_name: str
    parent: Optional[int]     # index in the snapshot of the enclosing span, same thread
    frame: Optional[int]      # Shell.id of the frame it works on
    attrs: dict
    counts: Optional[dict]    # a root span's counts made on its thread while open


class _Thread:
    """One thread's record: its spans (in start order), its open spans and
    its counter totals. Only the owning thread writes it."""

    __slots__ = ("gen", "ident", "name", "spans", "stack", "counts")

    def __init__(self, gen: int):
        cur = threading.current_thread()
        self.gen, self.ident, self.name = gen, threading.get_ident(), cur.name
        self.spans: List[_Span] = []
        self.stack: List[int] = []
        self.counts: Dict[str, int] = {}


def _thread() -> _Thread:
    th = getattr(_tls, "th", None)
    if th is None or th.gen != _gen:
        with _lock:
            th = _Thread(_gen)
            _threads.append(th)
        _tls.th = th
    return th


class _NoSpan:
    """The shared span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def start_ns() -> int:
        """The clock now: what a recorded span would have stamped at its
        start, for a caller that times the interval itself."""
        return time.perf_counter_ns()

    end_ns = start_ns


NOSPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "frame", "attrs", "t0", "t1", "parent", "th", "counts0", "counts")

    def __init__(self, name, frame, attrs):
        self.name, self.frame, self.attrs = name, frame, attrs
        self.t1 = self.counts = None

    def __enter__(self):
        th = _thread()
        self.th = th
        self.parent = th.stack[-1] if th.stack else None
        if self.parent is None:
            self.counts0 = dict(th.counts)
        elif self.frame is None:
            self.frame = th.spans[self.parent].frame
        self.t0 = time.perf_counter_ns()
        th.stack.append(len(th.spans))
        th.spans.append(self)
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        th = self.th
        th.stack.pop()
        if self.parent is None:
            c0 = self.counts0
            self.counts = {k: v - c0.get(k, 0) for k, v in th.counts.items()
                           if v != c0.get(k, 0)}
        return False

    def start_ns(self) -> int:
        return self.t0

    def end_ns(self) -> int:
        return self.t1


def span(name: str, frame: Optional[int] = None, **attrs):
    """A context manager that records `name` around its block while the
    tracer is on; `frame` is the Shell.id the block works on (inherited
    from the enclosing span when None)."""
    if not _on:
        return NOSPAN
    return _Span(name, frame, attrs)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while the tracer is on."""
    if not _on:
        return
    c = _thread().counts
    c[name] = c.get(name, 0) + n


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn the tracer on with an empty record."""
    global _on, _gen, _threads
    with _lock:
        _gen += 1
        _threads = []
    _on = True


def disable() -> None:
    """Turn the tracer off; what it recorded stays for snapshot()."""
    global _on
    _on = False


def snapshot() -> dict:
    """{"spans": [SpanRecord, ...], "counters": {name: total}}: every span
    recorded since enable(), thread by thread in start order (`parent`
    indexes this list), and the counter totals over all threads."""
    with _lock:
        threads = list(_threads)
    spans: List[SpanRecord] = []
    counters: Dict[str, int] = {}
    for th in threads:
        base = len(spans)
        for s in list(th.spans):
            spans.append(SpanRecord(
                s.name, s.t0, s.t1, th.ident, th.name,
                None if s.parent is None else base + s.parent, s.frame, dict(s.attrs),
                None if s.counts is None else dict(s.counts)))
        for k, v in dict(th.counts).items():
            counters[k] = counters.get(k, 0) + v
    return {"spans": spans, "counters": counters}


def chrome_trace(snap: dict) -> dict:
    """A snapshot as a Chrome trace (chrome://tracing, Perfetto): one track
    per thread, each span a complete event with its frame and attributes as
    args; the counter totals under "otherData". Spans still open are left
    out."""
    events, names = [], {}
    for s in snap["spans"]:
        names[s.thread] = s.thread_name
        if s.t1 is None:
            continue
        args = dict(s.attrs)
        if s.frame is not None:
            args["frame"] = s.frame
        if s.counts:
            args["counts"] = s.counts
        events.append({"name": s.name, "ph": "X", "pid": 0, "tid": s.thread,
                       "ts": s.t0 / 1e3, "dur": (s.t1 - s.t0) / 1e3, "args": args})
    meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid, "args": {"name": n}}
            for tid, n in names.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"counters": snap["counters"]}}
