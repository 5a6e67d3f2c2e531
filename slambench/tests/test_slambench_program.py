"""The metrics read from the program's own spans and counters
(slambench/program.py) on the CPU at the small size (tiny.py): a traced
run reports them and an untraced one does not; a run that fails, also
before its system exists, leaves the program's tracer off; the idle gaps are named by the program's span
path, on hand-made data."""
from __future__ import annotations

import pytest

from slambench import program, registry
from slambench import run as R
from slambench.tests.tiny import small_judges, tiny_root
from slambench.tracing import DeviceTrace, Spans

NEW = ("host_policy_ms", "track_span_ms", "lm_iters_per_frame", "host_syncs_per_frame",
       "bootstrap_s")


@pytest.fixture
def small(tmp_path, monkeypatch):
    small_judges(monkeypatch)
    return tiny_root(str(tmp_path))


def _run(root, trace):
    bench = registry.load_benchmark()
    return R.run_cell(bench, registry.cell(bench, "tum_mono_calib.laps"), 2 ** 31 + 9, 8.0,
                      trace, device="cpu", root=root, log=lambda m: None)


def test_traced_run_reports_the_program_metrics_and_untraced_none(small):
    from hslam_tpu_torch.utils import trace
    res = _run(small, True)
    assert not trace.enabled()
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(got), got
    assert got["host_syncs_per_frame"] > got["lm_iters_per_frame"] > 1
    assert 0 < got["host_policy_ms"] < got["track_span_ms"]
    assert got["bootstrap_s"] > 0
    assert res["metrics"]["lm_iters_per_frame"]["unit"] == "iters/frame"
    kept = trace.snapshot()
    res = _run(small, False)
    assert not trace.enabled() and trace.snapshot() == kept    # nothing recorded
    assert not set(NEW) & set(res["metrics"])


@pytest.mark.parametrize("when", ["bootstrap", "before_the_system"])
def test_a_failed_run_leaves_the_tracer_off(small, monkeypatch, when):
    from hslam_tpu_torch.models.system import SLAMSystem
    from hslam_tpu_torch.utils import trace
    close = SLAMSystem.__dict__["close"]
    if when == "bootstrap":
        monkeypatch.setattr(R, "MAX_INIT_FRAMES", 0)
        with pytest.raises(R.RunFailed, match="not initialized"):
            _run(small, True)
    else:
        def no_system(self, *a, **kw):
            assert trace.enabled()      # the tracer is on before the system is built
            raise RuntimeError("no system")
        monkeypatch.setattr(SLAMSystem, "__init__", no_system)
        with pytest.raises(RuntimeError, match="no system"):
            _run(small, True)
    assert not trace.enabled()
    assert SLAMSystem.__dict__["close"] is close


def test_idle_gaps_are_named_by_the_program_span_path():
    from hslam_tpu_torch.utils import trace
    spans = Spans()
    spans.add("entry", 1.0, 2.0)
    tid = spans.items[0].thread

    def rec(name, t0, t1, parent, thread=tid):
        return trace.SpanRecord(name, int(t0 * 1e9), int(t1 * 1e9), thread, "t", parent, 3, {},
                                None)
    snap = {"spans": [rec("frame", 1.0, 1.9, None), rec("track", 1.1, 1.85, 0),
                      rec("track.level", 1.5, 1.8, 1), rec("map.step", 1.0, 2.0, None, tid + 1)],
            "counters": {}}
    got = program.Reading(snap, 1.0, 2.0, tid)
    # kernels busy over [1.0, 1.2] and [1.3, 1.55] of a stretch from 1.0 to 2.0
    run = type("Run", (), {})()
    run.spans, run.profiled_from = spans, 1.0
    run.device = DeviceTrace(1.0, 0.45, [("k", 1.0, 0.2), ("k", 1.3, 0.25)], [], [])
    names = program.named_gaps(run, got)
    assert names[0] == ("entry|frame>track>track.level", pytest.approx(0.45))
    assert names[1] == ("entry|frame>track", pytest.approx(0.1))
    assert len(names) == 2
