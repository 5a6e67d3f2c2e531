"""Find the pieces of a run by name: a cell in BENCHMARK.json, its
configuration in configs/<config>.json, its traffic mix in
traffic/<traffic>.json, each per-layer metric's reader in
metrics/<metric>.py and each judged part's check in judges/<part>.py.
Adding a configuration, a mix, a cell, a metric or a judge is adding files
and entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def load_benchmark(repo: str = REPO) -> dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(root: str, kind: str, name: str) -> dict:
    path = os.path.join(root, kind, name + ".json")
    with open(path) as f:
        return json.load(f)


def config(name: str, root: str = HERE) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root: str = HERE) -> dict:
    return _json(root, "traffic", name)


def _module(kind: str, name: str, root: str, attrs) -> ModuleType:
    """<kind>/<name>.py, loaded from its path (names may hold dots) and
    registered in sys.modules under its own name, as dataclasses need."""
    path = os.path.join(root, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"slambench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    for attr in attrs:
        if not hasattr(mod, attr):
            raise AttributeError(f"{kind} {name}: {path} defines no {attr}")
    return mod


def metric_module(name: str, root: str = HERE) -> ModuleType:
    return _module("metrics", name, root, ("UNIT", "SOURCE", "read"))


def judge_module(name: str, root: str = HERE) -> ModuleType:
    """judges/<name>.py: a judged part's check (judge.py says what it declares)."""
    mod = _module("judges", name, root,
                  ("NUMBERS", "MINIMUMS", "AFTER", "SCOPE", "Capturer", "judge"))
    if mod.SCOPE not in ("run", "window"):
        raise ValueError(f"judge {name}: SCOPE {mod.SCOPE!r} is neither 'run' nor 'window'")
    return mod


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics a traced run of the cell reports: those that
    list it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
