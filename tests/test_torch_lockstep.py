"""The threaded SLAMSystem entries on a mesh of more than one rank: rank 0
tracks and makes every decision that depends on thread timing, the other
ranks replay it from control records (parallel/distributed.Channel,
models/system.py). Held here:
  (a) the records' layout: pack and unpack give back every bit;
  (b) replay in one process: rank 0's side records its streams through a
      scripted channel, a follower fed those streams ends with rank 0's
      shells, bit for bit (the pipelined entry with loop closure, the queued
      entry, the pipelined entry with online photometric calibration), also
      when rank 0's mapping thread was held so that its policy drained,
      dropped in catch-up, traced and keyframed;
  (c) the end mark and a follower that runs out of records;
  (d) one spawn of two ranks over Gloo, frames at a camera's pace, with a
      sleep in rank 1's mapping thread: the ranks' shells are the same bits;
  (e, slow) two ranks with loop closure, then with online calibration, held
      to the JAX package's pipelined system on a mesh of two XLA:CPU devices;
  (f) a follower holds the tracking reference rank 0 holds (its template,
      slot, affine and exposure, bit for bit), so that its checkpoint equals
      rank 0's array for array; a record naming a reference the follower
      never published raises after the bounded wait.

JAX is imported inside the slow test only: the spawned ranks import this
module by name and have torch only."""
import threading
import time

import numpy as np
import pytest
import torch

from hslam_tpu_torch.config import Config
from hslam_tpu_torch.io.synthetic import Scene, make_photocal_frames, make_sequence, sweep_xi
from hslam_tpu_torch.models import system as S
from hslam_tpu_torch.parallel import distributed as D

torch.set_num_threads(1)

H, W, FX = 96, 128, 80.0
CX, CY = W / 2 - 0.5, H / 2 - 0.5
# tests/test_torch_system.py's CFG (tests/test_system.py:50-55)
CFG_KW = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=400.0, desired_immature_density=300.0,
              tracker_iters_per_level=(6, 10, 10))


class ScriptedChannel(D.Channel):
    """A channel without a transport. Rank 0's side (no `stream`) records
    what it sends; a follower's side replays a recorded stream and raises
    once it has run out, as a follower that finds no record must."""

    def __init__(self, fields, stream=None):
        super().__init__(fields)
        self.leader = stream is None
        self.stream = [] if stream is None else list(stream)

    def _take(self):
        if not self.stream:
            raise RuntimeError("no record from rank 0")
        return self.stream.pop(0)

    def _bcast(self, buf):
        if self.leader:
            self.stream.append(buf.clone())
        else:
            buf.copy_(self._take())
        self.n_broadcasts += 1

    def _bcast_objects(self, box):
        if self.leader:
            self.stream.append([t.clone() for t in box[0]])
        else:
            box[0] = self._take()
        self.n_broadcasts += 1


def _scripted(monkeypatch, leader=None):
    """SLAMSystems made from here on get scripted channels: recording ones
    (rank 0) without `leader`, else replaying `leader`'s streams."""
    def channels(mesh, cfg):
        if leader is None:
            return ScriptedChannel(S.track_fields(cfg)), ScriptedChannel(S.MAP_FIELDS)
        return (ScriptedChannel(S.track_fields(cfg), leader._trk.stream),
                ScriptedChannel(S.MAP_FIELDS, leader._map.stream))
    monkeypatch.setattr(S, "_control_channels", channels)


def _system(**kw):
    kw.setdefault("enable_loop_closure", False)
    return S.SLAMSystem(FX, FX, CX, CY, W, H, Config(**CFG_KW), sequential=False,
                        device="cpu", **kw)


def _shells(slam):
    return [(s.id, s.pose_valid, s.is_kf, s.kf_id, s.tracking_ref, s.relocalized,
             s.cam_to_world, s.cam_to_ref, s.aff) for s in slam.shells]


def _assert_same_shells(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:6] == y[:6], (x[:6], y[:6])
        for u, v in zip(x[6:], y[6:]):
            np.testing.assert_array_equal(u, v, err_msg=f"shell {x[0]}")


def _sweep(n):
    return make_sequence(Scene(H, W, FX, n_blobs=16), n, lambda i: sweep_xi(i / 10.0))[0]


def _run(slam, frames, entry, exposures=None, hook=None):
    """Feed `frames` through `entry`, then flush, finish and close (on an
    error too, so that a follower's threads stop)."""
    try:
        for i, f in enumerate(frames):
            exp = 1.0 if exposures is None else float(exposures[i])
            if entry == "pipelined":
                slam.process_frame_pipelined(f, i / 10.0, exposure=exp)
            else:
                slam.process_frame(f, i / 10.0, exposure=exp)
            if hook is not None:
                hook(i)
        if entry == "pipelined":
            slam.flush_pipeline()
        slam.finish()
    finally:
        slam.close()
    return slam


# ---------------------------------------------------------------- (a)
RECORDS = {
    "tracking": (S.track_fields(Config(**CFG_KW)), dict(
        kind=S.R_DONE, sid=17, c2w=np.linalg.qr(np.random.default_rng(0).normal(size=(4, 4)))[0],
        c2r=np.random.default_rng(1).normal(size=(4, 4)), ref=12, aff=np.array([-0.0, 1e-300]),
        valid=True, reloc=False, retried=True, need_kf=True,
        rmse=np.array([3.25, np.nan, 100.0, 0.0, 0.0]), rmse_n=3, first_rmse=-1.0,
        flow=np.float32([0.1, 2.5, 3.0]).astype(np.float64), fit=False, tref=15, fit_pend=-1)),
    "mapping": (S.MAP_FIELDS, dict(
        kind=S.M_STEP, sid=2 ** 53, n_drop=9, action=S.KF_DEFER, extra=-1, corr=3,
        ref_slot=5, iw_scale=float(np.float64(1.0) + np.finfo(np.float64).eps), resync_fit=2)),
    "mark": (S.MAP_FIELDS, dict(
        kind=S.M_END, sid=-1, n_drop=0, action=S.TRACE, extra=-1, corr=-1, ref_slot=-1,
        iw_scale=1.0, resync_fit=0)),
}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_record_round_trip_is_bit_exact(name):
    fields, rec = RECORDS[name]
    ch = D.Channel(fields)
    buf = ch.pack(**rec)
    assert buf.dtype == torch.float64 and buf.numel() == ch.numel
    back = ch.unpack(buf)
    assert set(back) == set(rec)
    for k, v in rec.items():
        want = np.asarray(v, np.float64)
        assert np.asarray(back[k]).shape == want.shape, k
        # bit for bit: NaN, -0.0, 2**53 and the last ulp survive
        assert np.asarray(back[k]).tobytes() == want.tobytes(), k
    with pytest.raises(KeyError):
        ch.pack(**{k: v for k, v in rec.items() if k != "sid"})
    with pytest.raises(ValueError):
        ch.pack(**{**rec, "sid": np.zeros(2)})


@pytest.mark.parametrize("kind", ["tracked", "relocalized"])
def test_follower_shell_from_record_equals_rank0s(monkeypatch, kind):
    """A shell written from rank 0's record equals rank 0's shell, and the
    tracker state it carries lands on the follower."""
    _scripted(monkeypatch)
    lead = _system()
    try:
        rng = np.random.default_rng(3)
        src = S.Shell(id=0, timestamp=0.0, exposure=1.0, cam_to_world=rng.normal(size=(4, 4)),
                      tracking_ref=None if kind == "relocalized" else 0,
                      cam_to_ref=rng.normal(size=(4, 4)), aff=rng.normal(size=2),
                      pose_valid=kind == "tracked", relocalized=kind == "relocalized")
        lead.last_coarse_rmse = rng.normal(size=3)
        lead.first_coarse_rmse = 0.75
        lead._last_flow = rng.normal(size=3)
        lead._send_frame(S.R_DONE, src, need_kf=True, retried=kind == "relocalized")
    finally:
        lead.close()
    _scripted(monkeypatch, lead)
    fol = _system()
    try:
        dst = S.Shell(id=0, timestamp=0.0, exposure=1.0, cam_to_world=np.eye(4),
                      tracking_ref=None, cam_to_ref=np.eye(4), aff=np.zeros(2))
        assert fol._follower
        assert fol._apply_frame(dst, fol._recv_frame(S.R_DONE)) is True
    finally:
        fol.close()
    assert dst.tracking_ref == src.tracking_ref
    assert (dst.pose_valid, dst.relocalized) == (src.pose_valid, src.relocalized)
    for a, b in ((dst.cam_to_world, src.cam_to_world), (dst.cam_to_ref, src.cam_to_ref),
                 (dst.aff, src.aff), (fol.last_coarse_rmse, lead.last_coarse_rmse),
                 (fol._last_flow, lead._last_flow)):
        assert a.tobytes() == np.asarray(b, np.float64).tobytes()
    assert fol.first_coarse_rmse == 0.75
    assert (fol.n_relocs, fol.n_track_retries) == (int(kind == "relocalized"),) * 2


# ---------------------------------------------------------------- (b)
CASES = {
    # entry, frames, system keywords
    "pipelined_loop_closure": ("pipelined", 14, dict(enable_loop_closure=True)),
    "queued": ("queued", 12, {}),
    "pipelined_photo_calib": ("pipelined", 26, dict(online_photo_calib=True,
                                                    photo_calib_every=8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_follower_replays_rank0_bit_for_bit(monkeypatch, case):
    """Rank 0's streams recorded, then replayed by a follower: the same
    shells, keyframes, window and statistics; the follower tracked nothing
    and built one pyramid per frame."""
    from hslam_tpu_torch.ops import pyramid as P
    entry, n, kw = CASES[case]
    if kw.get("online_photo_calib"):
        frames, exps, _ = make_photocal_frames(Scene(H, W, FX, n_blobs=16), n)
    else:
        frames, exps = _sweep(n), None
    _scripted(monkeypatch)
    lead = _run(_system(**kw), frames, entry, exps)
    assert lead.initialized and lead.next_kf_id >= 3
    if kw.get("online_photo_calib"):
        assert lead.n_photo_fits >= 2
    _scripted(monkeypatch, lead)
    P.plain_calls = 0
    fol = _run(_system(**kw), frames, entry, exps)
    assert fol._follower and fol._trk_ended and not fol._trk.stream and not fol._map.stream
    assert P.plain_calls == n            # CPU tensors: the plain pyramid, one per frame
    _assert_same_shells(_shells(lead), _shells(fol))
    assert (fol.next_kf_id, fol.n_frames_skipped, fol.n_photo_fits, fol.ind_obs_history) == (
        lead.next_kf_id, lead.n_frames_skipped, lead.n_photo_fits, lead.ind_obs_history)
    for a, b in zip(lead.window.frames, fol.window.frames):
        assert torch.equal(a, b)
    assert torch.equal(lead.window.points.idepth, fol.window.points.idepth)
    if kw.get("online_photo_calib"):
        assert all(torch.equal(a, b) for a, b in zip(lead._pc_luts, fol._pc_luts))
    if kw.get("enable_loop_closure"):
        assert len(fol.loop_closer.entries) == len(lead.loop_closer.entries) >= 2


def test_replay_of_a_stream_that_drains_drops_traces_and_keyframes(monkeypatch):
    """Rank 0's mapping thread held twice while frames queue up (the queued
    entry on live input enqueues as it is called): its policy drains (drops
    all but the freshest), drops every second frame in catch-up, traces and
    keyframes. The follower, which queues frames as fast as it likes,
    executes that stream and ends with rank 0's shells."""
    frames = _sweep(26)
    _scripted(monkeypatch)
    lead = _system(live_input=True)
    gates = [threading.Event(), threading.Event()]
    entered = [threading.Event(), threading.Event()]
    execute = lead._map_execute
    steps = []

    def held(*step):
        k = len(steps)
        steps.append(step[0].id)
        if k < 2:
            entered[k].set()
            assert gates[k].wait(60.0)
        return execute(*step)

    monkeypatch.setattr(lead, "_map_execute", held)
    state = {"phase": 0, "queued": 0}

    def hook(i):
        # phase 0: until step 0 is held; phase 1: 10 more frames, release,
        # until step 1 is held; phase 2: 5 more, release
        if state["phase"] == 0 and entered[0].is_set():
            state["phase"], state["queued"] = 1, len(lead._queue)
        elif state["phase"] in (1, 2):
            want = 10 if state["phase"] == 1 else 5
            if len(lead._queue) - state["queued"] >= want:
                gates[state["phase"] - 1].set()
                assert entered[state["phase"] - 1].wait(60.0)
                if state["phase"] == 1:
                    assert entered[1].wait(60.0)
                state["phase"] += 1
                state["queued"] = len(lead._queue)

    try:
        _run(lead, frames, "queued", hook=hook)
    finally:
        for g in gates:
            g.set()
    decs = [lead._map.unpack(b) for b in lead._map.stream]
    actions = {int(d["action"]) for d in decs if d["kind"] == S.M_STEP}
    assert any(d["n_drop"] > 0 for d in decs), "no drain"
    assert any(d["extra"] >= 0 for d in decs), "no catch-up drop"
    assert {S.KF_FORCED, S.TRACE} <= actions and lead.n_frames_skipped >= 10
    _scripted(monkeypatch, lead)
    fol = _run(_system(live_input=True), frames, "queued")
    _assert_same_shells(_shells(lead), _shells(fol))
    assert (fol.next_kf_id, fol.n_frames_skipped) == (lead.next_kf_id, lead.n_frames_skipped)


# ---------------------------------------------------------------- (c)
def test_follower_without_a_record_raises(monkeypatch):
    """A follower never tracks on its own: with no record from rank 0 its
    entry raises, and its close raises too (no end mark either)."""
    _scripted(monkeypatch)
    lead = _system()
    lead.close()                          # its end marks: rank 0's mapping thread stops
    lead._trk.stream.clear()
    _scripted(monkeypatch, lead)
    fol = _system()
    with pytest.raises(RuntimeError, match="no record"):
        fol.process_frame_pipelined(_sweep(1)[0], 0.0)
    with pytest.raises(RuntimeError, match="no record"):
        fol.close()
    assert fol._map_thread is None


def test_end_mark_stops_a_waiting_follower(monkeypatch):
    """Rank 0's close sends its end marks: a follower still expecting a
    frame's record raises on it, its close then takes nothing more, and its
    mapping thread ends on the mapping end mark."""
    frames = _sweep(4)
    _scripted(monkeypatch)
    lead = _system()
    for i, f in enumerate(frames[:2]):
        lead.process_frame_pipelined(f, i / 10.0)
    lead.close()                          # without flush or finish: a failed rank 0
    kinds = [lead._trk.unpack(b)["kind"] for b in lead._trk.stream]
    assert kinds[-1] == S.R_END and lead._trk_ended
    assert lead._map.unpack(lead._map.stream[-1])["kind"] == S.M_END
    _scripted(monkeypatch, lead)
    fol = _system()
    try:
        for i, f in enumerate(frames[:2]):
            fol.process_frame_pipelined(f, i / 10.0)
        with pytest.raises(RuntimeError, match="ended the tracking stream"):
            fol.process_frame_pipelined(frames[2], 0.2)
    finally:
        fol.close()
    assert fol._trk_ended and not fol._trk.stream and not fol._map.stream
    assert fol._map_thread is None


# ---------------------------------------------------------------- (d)
def _lockstep_worker(mesh, frames, sleep_rank, kw, pace_s=0.0):
    """The pipelined system on one rank of a mesh, with a sleep of 0.8 s
    before each of `sleep_rank`'s mapping steps, fed a frame every `pace_s`
    seconds (a camera's rate). Returns the shells and counts."""
    torch.set_num_threads(1)
    from hslam_tpu_torch.ops import pyramid as P
    exps = kw.pop("exposures", None)
    slam = S.SLAMSystem(FX, FX, CX, CY, W, H, Config(**CFG_KW), sequential=False,
                        device="cpu", dist_mesh=mesh, **kw)
    if mesh.rank == sleep_rank:
        execute = slam._map_execute

        def slow(*step):
            time.sleep(0.8)
            return execute(*step)
        slam._map_execute = slow
    P.plain_calls = 0
    _run(slam, frames, "pipelined", exps, hook=lambda i: time.sleep(pace_s))
    return dict(shells=_shells(slam), kfs=slam.next_kf_id, skipped=slam.n_frames_skipped,
                plain=P.plain_calls, follower=slam._follower, fits=slam.n_photo_fits,
                initialized=slam.initialized, lost=slam.is_lost,
                records=(slam._trk.n_broadcasts, slam._map.n_broadcasts),
                loops=None if slam.loop_closer is None else len(slam.loop_closer.entries),
                collectives=mesh.n_collectives)


def test_two_ranks_pipelined_in_lockstep_under_a_sleep():
    """One spawn of two ranks over Gloo: the pipelined entry with the
    mapping thread on a dist_mesh of two, frames at 2.5 fps, rank 1's
    mapping thread slowed by 0.8 s a step. Rank 0's mapping thread keeps up
    and keyframes the frame its latch asks for while rank 1's queue holds
    more (ranks deciding on their own then issue different collectives and
    fail). Rank 0 decides, rank 1 replays: the same shells, bit for bit,
    the BA sharded over both."""
    frames = _sweep(12)
    r0, r1 = D.run_ranks(_lockstep_worker, 2, args=(frames, 1, {}, 0.4), timeout=600)
    assert (r0["follower"], r1["follower"]) == (False, True)
    assert r0["initialized"] and not r0["lost"] and r0["kfs"] >= 3 and r0["collectives"] > 0
    _assert_same_shells(r0["shells"], r1["shells"])
    assert (r0["kfs"], r0["skipped"], r0["records"]) == (r1["kfs"], r1["skipped"], r1["records"])
    assert r0["plain"] >= r1["plain"] == len(frames)


# ---------------------------------------------------------------- (e)
def _jax_pipelined_on_two_devices(frames, exps, kw):
    import jax
    from jax.sharding import Mesh

    from hslam_tpu.config import Config as JConfig
    from hslam_tpu.models.system import SLAMSystem as JSLAM
    mesh = Mesh(np.array(jax.devices()[:2]), ("points",))
    js = JSLAM(FX, FX, CX, CY, W, H, JConfig(**CFG_KW), sequential=False, dist_mesh=mesh, **kw)
    try:
        for i, f in enumerate(frames):
            js.process_frame_pipelined(f, i / 10.0, exposure=float(exps[i]))
        js.flush_pipeline()
        js.finish()
    finally:
        js.close()
    return js


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["loop_closure", "photo_calib"])
def test_two_ranks_pipelined_held_to_jax(mode):
    """The 14 frames of tests/test_torch_dist.py::
    test_system_with_dist_mesh_two_ranks through the pipelined entry on two
    ranks (loop closure on the shipped vocabulary; then online photometric
    calibration, a fit every 4 frames, on those frames under a gamma of
    0.8 and a known exposure flicker), against the JAX package's pipelined
    system on a mesh of two XLA:CPU devices over the same frames. Both
    initialize and keep every pose valid, both ATEs are under that test's
    0.15, the port's within 1.5x the JAX one + 0.02; keyframes are reported,
    not held (C7); the two ranks' shells are the same bits."""
    import jax.numpy as jnp

    import test_system
    from hslam_tpu.utils import lie
    from hslam_tpu_torch.io.trajectory import ate_rmse
    I0 = test_system.make_texture()
    gt, frames = [], []
    for i in range(14):
        t = i / 10.0
        xi = jnp.array([0.35 * np.sin(0.5 * t), 0.18 * (1 - np.cos(0.5 * t)), 0.05 * t,
                        0.015 * np.sin(0.4 * t), 0.025 * t, 0.01 * np.sin(0.3 * t)])
        R, tt = lie.se3_exp(xi)
        Tcw = np.eye(4)
        Tcw[:3, :3], Tcw[:3, 3] = np.asarray(R), np.asarray(tt)
        gt.append(np.linalg.inv(Tcw)[:3, 3])
        frames.append(np.asarray(test_system.render(I0, R, tt)))
    exps = np.ones(len(frames))
    if mode == "loop_closure":
        kw = dict(enable_loop_closure=True)
    else:
        kw = dict(enable_loop_closure=False, online_photo_calib=True, photo_calib_every=4)
        exps = 1.0 + 0.2 * np.sin(np.arange(len(frames)))
        frames = [np.clip(255.0 * ((f * e) / 255.0) ** 0.8, 0, 255) for f, e in zip(frames, exps)]
    js = _jax_pipelined_on_two_devices(frames, exps, kw)
    r0, r1 = D.run_ranks(_lockstep_worker, 2, args=(frames, 1, dict(kw, exposures=exps), 0.4),
                         timeout=1200)
    _assert_same_shells(r0["shells"], r1["shells"])

    def ate(shells):
        ids = [s[0] for s in shells]
        return ate_rmse(np.array([gt[i] for i in ids]), np.array([s[6][:3, 3] for s in shells]))

    jsh = [(s.id, s.pose_valid, s.is_kf, s.kf_id, s.tracking_ref, s.relocalized,
            s.cam_to_world) for s in js.shells]
    ate_j, ate_t = ate(jsh), ate(r0["shells"])
    print(f"[{mode}] JAX keyframes {js.next_kf_id} ATE {ate_j:.6f} fitted "
          f"{js._pc_params is not None}; port keyframes {r0['kfs']} ATE {ate_t:.6f} "
          f"fits {r0['fits']} loop entries {r0['loops']}")
    assert js.initialized and r0["initialized"]
    assert all(s[1] for s in jsh) and all(s[1] for s in r0["shells"])
    assert ate_j < 0.15 and ate_t < 0.15 and ate_t <= 1.5 * ate_j + 0.02, (ate_t, ate_j)
    if mode == "photo_calib":
        assert r0["fits"] >= 1 and js._pc_params is not None


# ---------------------------------------------------------------- (f)
def _same_checkpoints(a, b):
    """Two io/checkpoint files: the same keys, and each array (the JSON
    __meta__ too) the same dtype, shape and bytes."""
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        x, y = da[k], db[k]
        assert (x.dtype, x.shape) == (y.dtype, y.shape) and x.tobytes() == y.tobytes(), k


# the queued entry with online calibration, rank 0's mapping thread idle
# after every call and rank 0 adopting no new reference until the first fit:
# that fit lands with a newer reference staged, which it re-corrects
STAGED = ("queued", 26, dict(online_photo_calib=True, photo_calib_every=8))


@pytest.mark.parametrize("case", sorted(CASES) + ["queued_photo_calib_staged"])
def test_follower_holds_rank0s_reference_and_checkpoints_alike(monkeypatch, tmp_path, case):
    """After every entry call, a follower holds the tracking reference that
    rank 0 holds (the keyframe and every template leaf), and after the run
    also its slot, affine, exposure and tracker residuals, bit for bit, so
    that io/checkpoint saves it (C21) and the two files are equal; each
    loads into a fresh system, and the two restored systems are equal."""
    from hslam_tpu_torch.io import checkpoint as ckpt
    entry, n, kw = CASES.get(case, STAGED)
    if kw.get("online_photo_calib"):
        frames, exps, _ = make_photocal_frames(Scene(H, W, FX, n_blobs=16), n)
    else:
        frames, exps = _sweep(n), None
    held = {}

    def holding(slam, idle=False):
        # the reference held after each entry call (templates are replaced,
        # never written in place)
        held[slam] = []

        def hook(i):
            if idle:
                slam._wait_mapping_idle()
            held[slam].append((slam.ref_shell_id, slam.template))
        return hook

    _scripted(monkeypatch)
    lead = _system(**kw)
    staged = case not in CASES
    if staged:
        adopt = lead._adopt_pending_ref
        monkeypatch.setattr(lead, "_adopt_pending_ref", lambda: (
            None if lead.template is not None and lead._pc_luts is None else adopt()))
    _run(lead, frames, entry, exps, hook=holding(lead, idle=staged))
    if staged:
        recs = [lead._trk.unpack(b) for b in lead._trk.stream if isinstance(b, torch.Tensor)]
        assert any(r["fit"] and r["fit_pend"] > r["tref"] >= 0 for r in recs)
    _scripted(monkeypatch, lead)
    fol = _system(**kw)
    _run(fol, frames, entry, exps, hook=holding(fol))
    assert fol._follower and lead.template is not None and lead.ref_shell_id >= 0
    for (ia, ta), (ib, tb) in zip(held[lead], held[fol]):
        assert ia == ib and (ta is None) == (tb is None)
        if ta is not None:
            assert all(torch.equal(u, v) for x, y in zip(ta, tb) for u, v in zip(x, y)), ia
    assert (fol.ref_shell_id, fol.ref_slot, fol.ref_exposure, fol.first_coarse_rmse) == (
        lead.ref_shell_id, lead.ref_slot, lead.ref_exposure, lead.first_coarse_rmse)
    for a, b in ((fol.ref_aff, lead.ref_aff), (fol.last_coarse_rmse, lead.last_coarse_rmse)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    for x, y in zip(lead.template, fol.template):
        assert len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y))
    if kw.get("online_photo_calib"):
        assert lead.n_photo_fits >= 2     # the first fit re-corrected the template
    files = [str(tmp_path / f"{who}.npz") for who in ("rank0", "follower")]
    ckpt.save_state(files[0], lead)
    ckpt.save_state(files[1], fol)
    _same_checkpoints(*files)
    restored = []
    for f in files:
        s = S.SLAMSystem(FX, FX, CX, CY, W, H, Config(**CFG_KW), enable_loop_closure=False,
                         device="cpu")
        ckpt.load_state(f, s)
        restored.append(s)
    a, b = restored
    _assert_same_shells(_shells(a), _shells(b))
    assert (a.ref_shell_id, a.ref_slot, a.next_kf_id) == (b.ref_shell_id, b.ref_slot, b.next_kf_id)
    for x, y in zip(a.template, b.template):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert all(torch.equal(u, v) for u, v in zip(a.window.frames, b.window.frames))


def test_follower_waits_for_an_unpublished_reference_then_raises(monkeypatch):
    """Rank 0's record names a reference (frame 7's) that this rank's
    mapping thread never publishes: the follower waits the bounded time for
    it, then raises, holding no reference; its close then takes the end
    marks as usual."""
    _scripted(monkeypatch)
    lead = _system()
    try:
        src = S.Shell(id=0, timestamp=0.0, exposure=1.0, cam_to_world=np.eye(4), tracking_ref=7,
                      cam_to_ref=np.eye(4), aff=np.zeros(2))
        lead.ref_shell_id = 7
        lead._send_frame(S.R_DONE, src)
    finally:
        lead.close()
    assert lead._trk.unpack(lead._trk.stream[0])["tref"] == 7
    _scripted(monkeypatch, lead)
    monkeypatch.setattr(S, "REPLAY_TIMEOUT_S", 0.5)
    fol = _system()
    try:
        dst = S.Shell(id=0, timestamp=0.0, exposure=1.0, cam_to_world=np.eye(4),
                      tracking_ref=None, cam_to_ref=np.eye(4), aff=np.zeros(2))
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError, match="frame 7's reference, which this rank never "
                                               "published"):
            fol._apply_frame(dst, fol._recv_frame(S.R_DONE))
        assert 0.5 <= time.perf_counter() - t0 < 30.0
        assert fol.template is None and fol.ref_shell_id == -1
    finally:
        fol.close()
    assert fol._trk_ended and fol._map_thread is None
