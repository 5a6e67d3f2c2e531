"""Whole runs of the harness on the CPU at a small size (tiny.py), the look
for a card skipped: the sound run is correct, its control and each fault
a cell can have are not, a metric and a judge added as files are reported
and held, `limits` that no judge or two judges read fail the run before
its set-up, and a one-way path that runs out fails the run instead of
wrapping. The faults:
the tracker or the calibration fit returning its state unchanged, its
answer altered where it is produced, and half of each rectified frame left
out; a one-chip cell has no exchange between chips to leave out."""
from __future__ import annotations

import functools
import json
import os

import pytest
import torch

from slambench import registry
from slambench import run as R
from slambench.tests.tiny import small_judges, tiny_root

SECONDS = 8.0


@pytest.fixture
def small(tmp_path, monkeypatch):
    small_judges(monkeypatch)
    return tiny_root(str(tmp_path))


# the pipelined cell, measured but left out of BENCHMARK.json for its spread
EUROC_CELL = {"name": "euroc_mh.laps", "config": "euroc_mh", "traffic": "laps", "chips": 1,
              "why": "the pipelined entry"}


def _bench():
    bench = registry.load_benchmark()
    if not any(w["name"] == EUROC_CELL["name"] for w in bench["workloads"]):
        bench["workloads"].append(dict(EUROC_CELL))
        for m in bench["per_layer"]:
            if "tum_mono_calib.laps" in m.get("workloads", []):
                m["workloads"].append(EUROC_CELL["name"])
    return bench


def _run(root, name="euroc_mh.laps", trace=False, control=False, bench=None, seed=2 ** 31 + 5):
    bench = bench or _bench()
    return R.run_cell(bench, registry.cell(bench, name), seed, SECONDS, trace, device="cpu",
                      control=control, root=root, log=lambda m: None)


@pytest.mark.parametrize("name", ["euroc_mh.laps", "tum_mono_calib.laps"])
def test_sound_run_is_correct_and_its_control_is_not(small, name):
    res = _run(small, name, control=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    limits = registry.config(name.split(".")[0])["limits"]
    over = [k for k in limits if res["control"][k] > limits[k]]
    assert over, res["control"]


def _break_tracker(monkeypatch, how):
    from hslam_tpu_torch.ops import tracker as trk
    orig = trk.track_coarse

    @functools.wraps(orig)
    def broken(template, target_pyr, K_pyr, R0, t0, aff0, *a, **kw):
        res = orig(template, target_pyr, K_pyr, R0, t0, aff0, *a, **kw)
        if how == "unchanged":
            return res._replace(R=R0, t=t0, aff=aff0)
        # altered where produced: a 3 degree turn about the optical axis
        c, s = torch.cos(torch.tensor(0.05)), torch.sin(torch.tensor(0.05))
        rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=res.R.dtype)
        return res._replace(R=rot.to(res.R.device) @ res.R)
    monkeypatch.setattr(trk, "track_coarse", broken)


@pytest.mark.parametrize("name", ["euroc_mh.laps", "tum_mono_calib.laps"])
@pytest.mark.parametrize("fault", ["unchanged", "altered", "half_frame"])
def test_a_broken_timed_path_is_not_correct(small, monkeypatch, fault, name):
    if fault == "half_frame":
        from hslam_tpu_torch.ops import undistort
        orig = undistort.remap_image

        def half(img, remap):
            out = orig(img, remap)
            out[out.shape[0] // 2:] = 0.0
            return out
        monkeypatch.setattr(undistort, "remap_image", half)
    else:
        _break_tracker(monkeypatch, fault)
    try:
        res = _run(small, name)
    except R.RunFailed:
        return              # the broken path did not even bootstrap: no answer came
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_calibration_fit_is_not_correct(small, monkeypatch, fault):
    """The online refit returning its start unchanged, or its vignette
    altered where it is produced, is caught by calib_gap."""
    from hslam_tpu_torch.models import photo_calib as PC
    orig = PC.calibrate

    def broken(params, *a, **kw):
        new, rms = orig(params, *a, **kw)
        if fault == "unchanged":
            return params, rms
        return new._replace(vig=new.vig + torch.tensor([0.1, 0.0, 0.0], device=new.vig.device)), rms
    monkeypatch.setattr(PC, "calibrate", broken)
    res = _run(small, "tum_mono_calib.laps")
    assert res["checks"]["judged_fits"]["value"] >= res["checks"]["judged_fits"]["limit"]
    assert not res["correct"], res["checks"]
    assert res["checks"]["calib_gap"]["value"] > res["checks"]["calib_gap"]["limit"]


def test_a_metric_added_as_a_file_is_reported(small):
    with open(os.path.join(small, "metrics", "entry_calls.py"), "w") as f:
        f.write('UNIT = "calls"\nSOURCE = {"harness": ["entry"]}\n\n\n'
                'def read(run):\n    return float(len(run.spans.of("entry")))\n')
    bench = _bench()
    bench["per_layer"].append({"name": "entry_calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "fps",
                               "workloads": ["euroc_mh.laps"]})
    res = _run(small, trace=True, bench=bench)
    assert res["metrics"]["entry_calls"]["value"] >= res["attempted"]
    assert "track_ms" in res["metrics"] and "rectify_ms" in res["metrics"]
    assert "setup_s" not in res["metrics"]


def test_a_one_way_path_fails_rather_than_wrap(small, monkeypatch):
    monkeypatch.setattr(R, "MAX_INIT_FRAMES", 12)
    with open(os.path.join(small, "traffic", "sweep.json"), "w") as f:
        json.dump({"path": "line", "speed_m_s": 0.366, "wobble_rad": [0.02, 0.02, 0.03],
                   "wobble_period_s": 5.0, "gain_flicker": {"amp": 0.1, "freq": 0.8},
                   "noise_seed": 5, "rate_factor": 0.0}, f)
    bench = _bench()
    bench["workloads"].append({"name": "euroc_mh.sweep", "config": "euroc_mh",
                               "traffic": "sweep", "chips": 1, "why": "test"})
    with pytest.raises(R.RunFailed, match="no wrapping"):
        _run(small, "euroc_mh.sweep", bench=bench)


# A judge added as a file: each step of the pipelined entry's mapping thread
# (SLAMSystem._map_execute), captured with whether it ran on the thread that
# built the system; its number is the share that did, plus OFFSET.
MAPPER_JUDGE = """
import threading

from slambench.judge import Judged

NUMBERS = ("mapper_on_caller",)
MINIMUMS = {"mapper_steps": FLOOR}
AFTER = ()
SCOPE = "run"


class Capturer:
    def __init__(self, ctx):
        self.system, self.caller, self.captured = ctx.system, threading.get_ident(), []

    def install(self):
        step = self.system._map_execute

        def captured(*args, **kwargs):
            self.captured.append(threading.get_ident() == self.caller)
            return step(*args, **kwargs)
        self.system._map_execute = captured

    def remove(self):
        self.system.__dict__.pop("_map_execute", None)


def judge(captured, inputs, state, control):
    share = sum(captured) / max(len(captured), 1)
    return Judged({"mapper_on_caller": share + OFFSET}, {"mapper_steps": len(captured)}, [])
"""


def _write_judge(root, name, floor=3, offset=0.0, number="mapper_on_caller"):
    text = MAPPER_JUDGE.replace("FLOOR", str(floor)).replace("OFFSET", repr(offset))
    with open(os.path.join(root, "judges", name + ".py"), "w") as f:
        f.write(text.replace('"mapper_on_caller"', repr(number)))


def _add_limits(root, limits):
    path = os.path.join(root, "configs", "euroc_mh.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["limits"].update(limits)
    with open(path, "w") as f:
        json.dump(cfg, f)


@pytest.mark.parametrize("variant", ["sound", "broken", "short"])
def test_a_judge_added_as_a_file_is_held(small, variant):
    offset = 1.0 if variant == "broken" else 0.0
    _write_judge(small, "mapper", floor=10 ** 6 if variant == "short" else 3, offset=offset)
    _add_limits(small, {"mapper_on_caller": 0.5})
    res = _run(small)
    checks = res["checks"]
    assert list(checks) == ["rectify_gap", "pyramid_gap", "track_px_gap", "track_aff_gap",
                            "mapper_on_caller", "judged_calls", "mapper_steps"]
    assert checks["mapper_steps"]["value"] >= 3
    assert checks["mapper_on_caller"]["value"] == offset   # every step on the mapping thread
    assert res["correct"] == (variant == "sound"), checks


@pytest.mark.parametrize("fault", ["unread", "read_twice"])
def test_limits_no_judge_or_two_judges_read_fail_before_setup(small, monkeypatch, fault):
    from slambench import scene

    def no_setup(*a, **kw):
        raise AssertionError("set-up began")
    monkeypatch.setattr(scene, "render_stream", no_setup)
    if fault == "unread":
        key = "bogus_gap"
        _add_limits(small, {key: 1.0})
    else:
        key = "track_px_gap"
        _write_judge(small, "twin", number=key)
    with pytest.raises(R.RunFailed, match=key):
        _run(small)
