"""A cell of the benchmark at a size the CPU runs in seconds: the
configuration's files copied into a scratch root, the camera cut to a
quarter of its size in each direction and the capacities to the long-run
test's, every other piece as committed. The judges are the committed ones,
made to capture and count at the rate a CPU's short window reaches."""
from __future__ import annotations

import json
import os
import shutil

from slambench import registry

SMALL_CAPACITIES = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
                        pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
                        desired_point_density=400.0, desired_immature_density=300.0)


def quarter_camera(text: str) -> str:
    """camera.txt at a quarter of the sensor's and the output's size in each
    direction (absolute intrinsics scaled; relative ones kept)."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    first = lines[0].split()
    vals = [float(v) for v in first[1:]]
    if not (vals[2] < 1 and vals[3] < 1):
        vals[:4] = [v / 4 for v in vals[:4]]
    w, h = (int(v) // 4 for v in lines[1].split())
    ow, oh = (int(v) // 4 for v in lines[3].split())
    return (f"{first[0]} " + " ".join(repr(v) for v in vals)
            + f"\n{w} {h}\n{lines[2]}\n{ow} {oh}\n")


def small_judges(monkeypatch) -> None:
    """Judges loaded for the rest of the test capture one tracking call in 2
    and need one refit, not 3 (a CPU window holds a few)."""
    load = registry.judge_module

    def small(name, root=registry.HERE):
        mod = load(name, root)
        if name == "tracking":
            mod.CAPTURE_EVERY = 2
        if name == "photo_calib":
            mod.MINIMUMS = {"judged_fits": 1}
        return mod
    monkeypatch.setattr(registry, "judge_module", small)


def tiny_root(tmp: str, loop_closure: bool = False) -> str:
    """A copy of slambench's configs, traffic, metrics and judges under
    `tmp`, with every configuration cut to the small size."""
    for kind in ("configs", "traffic", "metrics", "judges"):
        shutil.copytree(os.path.join(registry.HERE, kind), os.path.join(tmp, kind))
    for name in os.listdir(os.path.join(tmp, "configs")):
        path = os.path.join(tmp, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["camera_txt"] = quarter_camera(cfg["camera_txt"])
        cfg["capacities"] = dict(SMALL_CAPACITIES)
        cfg["system"]["enable_loop_closure"] = loop_closure
        cfg["warmup_frames"] = 4
        with open(path, "w") as f:
            json.dump(cfg, f)
    return tmp
