"""What decides `correct`: the program's own answers, captured while it
runs, held against the plain reference (reference/) once the window has
closed.

Each judged part is a file, judges/<part>.py (registry.judge_module), and
the configuration's `limits` choose the parts: a judge runs when its
NUMBERS name a key there, and each key has to be read by exactly one judge,
or the run fails before its set-up. A judge module declares:
- NUMBERS: the `limits` keys it reads, each a gap (lower is better);
- MINIMUMS: {count: floor}, the counts its readings need to stand;
- AFTER: the judges whose results it reads, where they run;
- SCOPE: "run" (installed once the system is built, before the first
  bootstrap frame) or "window" (installed when the timed window opens);
- Capturer(ctx): install() and remove(), and `captured`, what it kept.
  remove() always runs, also on a failed run. A capture may be taken on
  any of the program's threads;
- judge(captured, inputs, state, control) -> Judged, after the window:
  `state` maps each judge of AFTER that ran to what it left.
`verdict` holds every number of every judge that ran to its limit, and
every count to its floor.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional

import torch

from slambench import registry


@dataclasses.dataclass
class Context:
    """What a capturer is built from."""
    seed: int
    system: object
    sequential: bool            # the configuration's entry is process_frame
    rate: float                 # frames per second of the stream
    recent: list                # the last frames handed over: [(index, rectified host frame)]


@dataclasses.dataclass
class Inputs:
    """What every judge is given after the window."""
    raw_of: Callable            # frame index -> raw uint8 host frame
    exp_of: Callable            # frame index -> exposure handed over with it
    lens: object                # reference/lens.py's parse of the camera.txt
    cfg: dict
    device: torch.device


@dataclasses.dataclass
class Judged:
    readings: Dict[str, float]  # each of the judge's NUMBERS
    counts: Dict[str, int]      # each of its MINIMUMS, and any others it reports
    rows: List[dict]            # one line each on standard error, as [judge] rows
    control: Optional[Dict[str, float]] = None  # NUMBERS with the control in the program's place
    left: object = None         # what judges that name this one in AFTER read


class BadLimits(ValueError):
    """A `limits` key that no judge, or more than one, reads."""


def select(limits: dict, root: str) -> Dict[str, object]:
    """The judges whose NUMBERS read the `limits` keys, by name, each after
    the judges named in its AFTER."""
    where = os.path.join(root, "judges")
    names = sorted(f[:-3] for f in os.listdir(where) if f.endswith(".py"))
    mods = {n: registry.judge_module(n, root) for n in names}
    readers = {k: [n for n in names if k in mods[n].NUMBERS] for k in limits}
    for k, who in readers.items():
        if len(who) != 1:
            raise BadLimits(f"limits key {k!r} is read by {len(who)} judges {who} "
                            f"in {where}; exactly one has to read it")
    chosen = {who[0] for who in readers.values()}
    checks = list(limits) + [c for n in sorted(chosen) for c in mods[n].MINIMUMS]
    if len(set(checks)) != len(checks):
        raise BadLimits(f"the judges {sorted(chosen)} name a check twice: {checks}")
    order: List[str] = []

    def visit(n, path):
        if n in order:
            return
        if n in path:
            raise BadLimits(f"judges wait on each other: {path + [n]}")
        for a in mods[n].AFTER:
            if a in chosen:
                visit(a, path + [n])
        order.append(n)
    for n in sorted(chosen):
        visit(n, [])
    return {n: mods[n] for n in order}


class Panel:
    """The judges a configuration's limits select, their capturers and
    their results."""

    def __init__(self, limits: dict, root: str):
        self.limits = limits
        self.judges = select(limits, root)
        self.capturers: Dict[str, object] = {}

    def install(self, scope: str, ctx: Context):
        for name, mod in self.judges.items():
            if mod.SCOPE == scope:
                self.capturers[name] = cap = mod.Capturer(ctx)
                cap.install()

    def remove(self):
        for cap in reversed(list(self.capturers.values())):
            cap.remove()

    def judge(self, inputs: Inputs, control: bool = False) -> Dict[str, Judged]:
        """Each judge's result, in AFTER order."""
        out: Dict[str, Judged] = {}
        for name, mod in self.judges.items():
            state = {a: out[a].left for a in mod.AFTER if a in out}
            out[name] = mod.judge(self.capturers[name].captured, inputs, state, control)
        return out

    def report_order(self) -> List[str]:
        """The judges in the order their first key comes in `limits`."""
        first = {}
        for i, k in enumerate(self.limits):
            for name, mod in self.judges.items():
                if k in mod.NUMBERS:
                    first.setdefault(name, i)
        return sorted(self.judges, key=first.__getitem__)

    def verdict(self, judged: Dict[str, Judged]):
        """(correct, checks): every number the configuration limits within
        its limit, and every judge's counts at their floors. `checks` maps
        each name to its reading and limit: the numbers in the order of
        `limits`, then the counts, judge by judge."""
        readings = {k: v for j in judged.values() for k, v in j.readings.items()}
        checks = {k: {"value": readings.get(k, math.inf), "limit": lim}
                  for k, lim in self.limits.items()}
        ok = all(c["value"] <= c["limit"] for c in checks.values())
        for name in self.report_order():
            for c, floor in self.judges[name].MINIMUMS.items():
                got = judged[name].counts.get(c, 0)
                checks[c] = {"value": got, "limit": floor}
                ok = ok and got >= floor
        return ok, checks

    def merged(self, judged: Dict[str, Judged], field: str) -> dict:
        """One field of every judge's result, merged in report order."""
        out = {}
        for name in self.report_order():
            out.update(getattr(judged[name], field) or {})
        return out


def lens_K(cam) -> list:
    """The rectified camera's level-0 (fx, fy, cx, cy)."""
    K = cam.out_K
    return [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])]


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest absolute difference, float64; inf where it is not finite."""
    d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
    return float(d) if bool(torch.isfinite(d)) else math.inf

