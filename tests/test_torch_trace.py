"""The port's tracer (hslam_tpu_torch/utils/trace.py) on the CPU, at 96x128
with the small config of tests/test_torch_system.py: (a) off by default it
records nothing; (b) on the sequential entry its spans nest on one thread
and carry their frame; (c) on the pipelined entry with the mapping thread
no parent link crosses threads and counts from several threads add up;
(d) `lm_iter` counts the LM's solves, from the record each result
carries; (e) `host_sync` counts the program's
host reads of tensors; (f) its clock is the one the benchmark maps onto
the profiler's; (g) the self-time arithmetic of `host_policy_ms`; (h) the
latency records are the spans' own stamps; and run_sequence --trace FILE
writes a Chrome trace."""
from __future__ import annotations

import json
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hslam_tpu_torch.config import Config
from hslam_tpu_torch.io.synthetic import Scene, make_sequence, sweep_xi
from hslam_tpu_torch.models.system import SLAMSystem
from hslam_tpu_torch.ops import tracker as trk
from hslam_tpu_torch.tools import run_sequence as RS
from hslam_tpu_torch.utils import trace
from slambench.program import Reading, self_ns

torch.set_num_threads(1)

H, W, FX = 96, 128, 80.0
CFG_KW = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=400.0, desired_immature_density=300.0,
              tracker_iters_per_level=(6, 10, 10))
N_FRAMES = 9

TABLE = {"frame", "pyramid", "track", "track.score", "track.level", "track.serial",
         "track.reloc", "calib.observe", "calib.fit", "kf", "kf.trace", "kf.features",
         "kf.ba", "kf.finalize", "nonkf", "init", "map.step", "lc.detect", "lc.correct",
         "flush"}
# the Tensor methods by which the host reads a tensor's value; indexing by
# a 0-d integer tensor reads that tensor too (inside C++, past the others)
READS = ("__float__", "__bool__", "__int__", "item", "tolist", "cpu", "__getitem__")


def _scalar_index(key) -> bool:
    keys = key if isinstance(key, tuple) else (key,)
    return any(isinstance(k, torch.Tensor) and k.dim() == 0
               and not k.is_floating_point() and k.dtype != torch.bool for k in keys)


def _system(sequential=True, **kw):
    return SLAMSystem(FX, FX, W / 2 - 0.5, H / 2 - 0.5, W, H, Config(**CFG_KW),
                      sequential=sequential, device="cpu", **kw)


def _frames(n=N_FRAMES):
    return make_sequence(Scene(H, W, FX, n_blobs=16), n, lambda i: sweep_xi(i / 10.0))[0]


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    trace.disable()


class _Reads:
    """Tensor reads made from inside hslam_tpu_torch, with their clock."""

    def __init__(self):
        self.at = []                 # (perf_counter_ns, method, file:line)
        self._saved = {}

    def install(self):
        for name in READS:
            orig = getattr(torch.Tensor, name)
            self._saved[name] = torch.Tensor.__dict__.get(name)

            def read(t, *a, _orig=orig, _name=name, **kw):
                f = sys._getframe(1)
                if f.f_globals.get("__name__", "").startswith("hslam_tpu_torch.") and (
                        _name != "__getitem__" or _scalar_index(a[0])):
                    self.at.append((time.perf_counter_ns(), _name,
                                    f"{f.f_code.co_filename}:{f.f_lineno}"))
                return _orig(t, *a, **kw)
            setattr(torch.Tensor, name, read)

    def remove(self):
        for name, orig in self._saved.items():
            if orig is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, orig)


@pytest.fixture(scope="module")
def seq_run():
    """N_FRAMES through the sequential entry with loop closure and the online
    calibration, the tracer on, the LM's solves inside track_coarse and the
    program's tensor reads counted alongside."""
    solves, depth = [0], threading.local()
    orig_tc, orig_solve = trk.track_coarse, trk._solve8

    def tc(*a, **kw):
        depth.n = getattr(depth, "n", 0) + 1
        try:
            return orig_tc(*a, **kw)
        finally:
            depth.n -= 1

    def solve(*a, **kw):
        if getattr(depth, "n", 0):
            solves[0] += 1
        return orig_solve(*a, **kw)

    reads = _Reads()
    slam = _system(enable_loop_closure=True, online_photo_calib=True, photo_calib_every=4)
    trk.track_coarse, trk._solve8 = tc, solve
    reads.install()
    trace.enable()
    try:
        for i, f in enumerate(_frames()):
            slam.process_frame(f, i / 10.0, 1.0 + 0.2 * np.sin(0.5 * i))
            assert not slam.is_lost
    finally:
        trace.disable()
        reads.remove()
        trk.track_coarse, trk._solve8 = orig_tc, orig_solve
        slam.close()
    return SimpleNamespace(slam=slam, snap=trace.snapshot(), solves=solves[0], reads=reads.at)


def test_off_by_default_records_nothing():
    """(a)"""
    assert not trace.enabled()
    trace.enable()
    trace.disable()                  # an empty record
    assert trace.span("frame") is trace.NOSPAN
    assert trace.span("track.level", level=2, repeat=False) is trace.NOSPAN
    slam = _system(enable_loop_closure=False)
    try:
        for i, f in enumerate(_frames(3)):
            slam.process_frame(f, i / 10.0)
    finally:
        slam.close()
    assert slam.initialized
    assert trace.snapshot() == {"spans": [], "counters": {}}


def test_sequential_spans_nest_and_carry_their_frame(seq_run):
    """(b)"""
    spans = seq_run.snap["spans"]
    names = {s.name for s in spans}
    assert names <= TABLE, names - TABLE
    assert {"frame", "pyramid", "init", "track", "track.score", "track.level", "kf",
            "kf.trace", "kf.features", "kf.ba", "kf.finalize", "nonkf", "calib.observe",
            "calib.fit", "lc.detect"} <= names, names
    assert seq_run.slam.n_photo_fits >= 1
    assert len({s.thread for s in spans}) == 1
    frames = [s for s in spans if s.name == "frame"]
    assert [s.frame for s in frames] == list(range(N_FRAMES))
    for i, s in enumerate(spans):
        assert s.t1 is not None and s.t0 <= s.t1 and s.frame is not None
        if s.name == "frame":
            assert s.parent is None and s.counts is not None
            continue
        p = spans[s.parent]
        assert p.t0 <= s.t0 and s.t1 <= p.t1 and p.thread == s.thread and s.parent < i
        assert s.frame == p.frame
    levels = [s.attrs for s in spans if s.name == "track.level"]
    assert {a["level"] for a in levels} == {0, 1, 2} and {a["repeat"] for a in levels} >= {False}
    n_init = len([s for s in spans if s.name == "init"])
    assert n_init >= 2 and len([s for s in spans if s.name == "track"]) == N_FRAMES - n_init


def test_pipelined_spans_stay_on_their_threads():
    """(c)"""
    slam = _system(sequential=False, enable_loop_closure=False)
    trace.enable()
    try:
        for i, f in enumerate(_frames(8)):
            slam.process_frame_pipelined(f, i / 10.0)
        slam.flush_pipeline()
        slam.finish()
    finally:
        trace.disable()
        slam.close()
    snap = trace.snapshot()
    spans = snap["spans"]
    main = threading.get_ident()
    steps = [s for s in spans if s.name == "map.step"]
    assert steps and all(s.thread != main and s.parent is None for s in steps)
    assert {s.frame for s in steps} <= set(range(8))
    assert all(s.thread == main for s in spans if s.name in ("frame", "track"))
    for s in spans:
        if s.parent is not None:
            assert spans[s.parent].thread == s.thread
        if s.name in ("kf", "nonkf") and s.thread != main:
            assert s.frame == spans[s.parent].frame
    roots = [s for s in spans if s.parent is None]
    for name in ("lm_iter", "hyp_scored"):
        assert snap["counters"][name] == sum((s.counts or {}).get(name, 0) for s in roots)
    assert snap["counters"]["hyp_scored"] == 32 * len([s for s in spans if s.name == "track"])


def test_counters_sum_over_threads():
    """(c) Eight threads counting at once under a short switch interval:
    no count is lost, and each root span keeps its own thread's counts."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        def work():
            with trace.span("map.step", frame=7):
                for _ in range(3000):
                    trace.count("host_sync")
                    trace.count("lm_iter", 2)
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    finally:
        trace.disable()
        sys.setswitchinterval(old)
    snap = trace.snapshot()
    assert snap["counters"] == {"host_sync": 24000, "lm_iter": 48000}
    assert [s.counts for s in snap["spans"]] == [{"host_sync": 3000, "lm_iter": 6000}] * 8
    assert len({s.thread_name for s in snap["spans"]}) == 8


def test_lm_iter_counts_the_solves_of_track_coarse(seq_run):
    """(d)"""
    assert seq_run.solves > 0
    assert seq_run.snap["counters"]["lm_iter"] == seq_run.solves
    cut = seq_run.snap["counters"].get("lm_cutoff_double", 0)
    assert 0 <= cut <= seq_run.solves


def test_lm_counts_come_from_the_pulled_record():
    """(d) The kernel's route counts nothing while it runs: `lm_iter` and
    `lm_cutoff_double` come from the result's record when the system pulls
    it, in the read it already makes, once per iteration and doubling."""
    res = trk.TrackResult(R=torch.eye(3), t=torch.zeros(3), aff=torch.zeros(2),
                          ok=torch.tensor(True), residuals=torch.tensor([0.5, 1.0, 2.0]),
                          flow=torch.tensor([1.0, 0.0, 2.0]),
                          lm=torch.tensor([[1, 3, 10], [0, 2, 1]], dtype=torch.int32))
    trace.enable()
    try:
        with trace.span("frame", frame=3):
            R, t, aff, ok, r, flow = SLAMSystem._pull_track(res)
            SLAMSystem._pull_track(res._replace(lm=None))
    finally:
        trace.disable()
    snap = trace.snapshot()
    assert snap["counters"] == {"host_sync": 2, "lm_iter": 14, "lm_cutoff_double": 3}
    assert snap["spans"][0].counts == snap["counters"]
    assert ok and np.array_equal(r, [0.5, 1.0, 2.0]) and np.array_equal(flow, [1.0, 0.0, 2.0])
    assert np.array_equal(R, np.eye(3))


def test_host_sync_counts_the_program_reads(seq_run):
    """(e) Over every frame, bootstrap and keyframes included: the program's
    reads of tensor values (the methods in READS, called from inside
    hslam_tpu_torch) made while a frame span was open equal the host_sync
    the frame counted. No read is left out."""
    frames = [s for s in seq_run.snap["spans"] if s.name == "frame"]
    at = sorted(seq_run.reads)
    for f in frames:
        inside = [r for r in at if f.t0 <= r[0] <= f.t1]
        assert (f.counts or {}).get("host_sync", 0) == len(inside), (f.frame, inside)
    assert sum((f.counts or {}).get("host_sync", 0) for f in frames) > 20 * (N_FRAMES - 2)


def test_spans_share_the_profilers_clock():
    """(f) A torch op run inside a span, as torch.profiler's CPU activity
    records it, mapped onto perf_counter as slambench/tracing.Profiler maps
    the trace, lies inside the span to within 0.2 ms."""
    x = torch.ones(100_000)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        offset = time.time() - time.perf_counter()
        trace.enable()
        for _ in range(5):
            with trace.span("frame"):
                x.mul_(1.0001)
            time.sleep(0.005)
        trace.disable()
    spans = trace.snapshot()["spans"]
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul_"]
    assert len(events) == len(spans) == 5
    for e, s in zip(sorted(events, key=lambda e: e.start_ns()), spans):
        a = e.start_ns() * 1e-9 - offset
        b = a + e.duration_ns() * 1e-9
        assert s.t0 * 1e-9 - 2e-4 <= a <= b <= s.t1 * 1e-9 + 2e-4, (a, b, s)


def test_host_policy_self_time_arithmetic():
    """(g) A frame of 100 ns whose children overlap, stick out of it and
    leave 10 + 15 + 5 ns uncovered; its grandchild counts nothing."""
    def rec(name, t0, t1, parent):
        return trace.SpanRecord(name, t0, t1, 1, "t", parent, 0, {}, None)
    spans = [rec("frame", 1000, 1100, None),          # 0
             rec("pyramid", 1010, 1030, 0),            # 1
             rec("track", 1025, 1060, 0),              # 2: overlaps 1
             rec("track.level", 1030, 1090, 2),        # 3: a grandchild
             rec("nonkf", 1075, 1095, 0),              # 4
             rec("kf", 1090, 1200, 0),                 # 5: past the frame's end
             rec("frame", 2000, 2040, None),           # 6: no children
             rec("init", 500, 600, None)]              # 7: set-up
    assert self_ns(spans[0], [spans[i] for i in (1, 2, 4, 5)]) == 10 + 15 + 0
    assert self_ns(spans[6], []) == 40
    got = Reading({"spans": spans, "counters": {}}, 900e-9, 3000e-9, 1)
    assert [s.name for s in got.of("init", "setup")] == ["init"]
    assert got.mean_self_ms() == pytest.approx(1e-6 * (25 + 40) / 2)
    assert got.path_at(1035) == "frame>track>track.level"
    assert got.path_at(1500) is None


def test_latency_records_are_the_spans_stamps(seq_run):
    """(h) Each keyframe's kf_full_latencies entry is its `kf` span's start
    to its `kf.finalize` span's end; each lc_detect_ms entry is its
    `lc.detect` span."""
    spans, slam = seq_run.snap["spans"], seq_run.slam
    kf = {s.frame: s for s in spans if s.name == "kf"}
    fin = [s for s in spans if s.name == "kf.finalize"]
    want = [1e-9 * (f.t1 - kf[f.frame].t0) for f in fin]
    assert len(want) >= 3 and list(slam.kf_full_latencies) == want
    det = [1e-6 * (s.t1 - s.t0) for s in spans if s.name == "lc.detect"]
    assert len(det) >= 2 and list(slam.lc_detect_ms) == det


def test_run_sequence_writes_a_chrome_trace(tmp_path):
    out, path = str(tmp_path / "traj.txt"), tmp_path / "trace.json"
    RS.run(RS.parse_args(["--synthetic", "4", "--out", out, "--device", "cpu",
                          "--trace", str(path)]), Config(**CFG_KW))
    assert not trace.enabled()
    doc = json.loads(path.read_text())
    main = [e["tid"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["args"]["name"] == "MainThread"]
    assert len(main) == 1
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    frames = [e for e in spans if e["name"] == "frame"]
    assert [e["args"]["frame"] for e in frames] == list(range(4))
    assert {e["tid"] for e in frames} == set(main)
    assert {e["name"] for e in spans} >= {"frame", "pyramid", "init"}
    for e in spans:
        assert e["dur"] >= 0 and e["args"]["frame"] in range(4)
    assert isinstance(doc["otherData"]["counters"], dict)
