"""The per-frame SLAM pipeline (port of hslam_tpu/models/system.py).

Two entries, as in the JAX package:
  * `process_frame`: pyramid (CUDA kernel on a CUDA device), then either the
    bootstrap (selector -> KLT -> two-view -> direct refinement -> KF0
    seeding with keypoint links) or tracking against the reference
    keyframe's template, the keyframe decision, and the keyframe step or
    non-keyframe tracing, inline (`sequential=True`) or handed to the
    mapping thread (`sequential=False`).
  * `process_frame_pipelined` (`sequential=False`): the fused per-frame
    `track_step` (pyramid, device-side motion hypotheses, scoring, LM) with
    the host finalization of a frame done `pipeline_lag` frames later, and
    keyframes made by the mapping thread, which publishes each new tracker
    reference through `_pending_ref`.

The host keeps the small state machine (shells, window slot bookkeeping,
policy mirrors refreshed from each keyframe's bundle), exactly as in the
JAX package; numeric work is torch on `device`.

Threads and the device: the tracking thread (the caller) and the mapping
thread enqueue their work on the same CUDA stream (the default one), so
every tensor one thread hands to the other was written by operations
enqueued before it was handed over; no event or `record_stream` is needed. State
shared between the threads is replaced, never mutated in place (the
keypoint store, the window, the calibration), and a mapping-thread
exception is raised on the tracking thread at its next call, by `finish`
or by `close`.

Refused with NotImplementedError, not silently skipped: loop closure,
online photometric calibration, point-sharded BA (`dist_mesh`) and the
metrics stream (`metrics_path`).
"""
from __future__ import annotations

import dataclasses
import threading
import time as _time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..models import kf_step as KS
from ..models import window as W
from ..models.calib import k_pyr_from_value, make_calib
from ..ops import features as FT
from ..ops import init_refine as ir_ops
from ..ops import klt as klt_ops
from ..ops import orb as orb_ops
from ..ops import pnp as pnp_ops
from ..ops import selector as sel_ops
from ..ops import tracker as trk_ops
from ..ops import twoview as tv_ops
from ..ops.pyramid import build_direct_pyramid, gaussian_blur7
from ..utils import lie
from ..utils.compaction import assign_free_slots, scatter_update


@dataclasses.dataclass
class Shell:
    """Host-side per-frame record (FrameShell)."""

    id: int
    timestamp: float
    exposure: float
    cam_to_world: np.ndarray
    tracking_ref: Optional[int]
    cam_to_ref: np.ndarray
    aff: np.ndarray
    is_kf: bool = False
    kf_id: int = -1
    pose_valid: bool = True
    relocalized: bool = False     # pose from relocalization: no velocity across it


def _se3_np(R, t):
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = np.asarray(R)
    T[:3, 3] = np.asarray(t)
    return T


def _se3_log_np(T):
    """float32 se3_log of a host 4x4 (as the JAX package computes it)."""
    R = torch.as_tensor(T[:3, :3], dtype=torch.float32)
    t = torch.as_tensor(T[:3, 3], dtype=torch.float32)
    return lie.se3_log(R, t).numpy().astype(np.float64)


def _se3_exp_np(xi):
    R, t = lie.se3_exp(torch.as_tensor(xi, dtype=torch.float32))
    return _se3_np(R.numpy(), t.numpy())


def _rot_perturbations(rot: float = 0.02) -> List[np.ndarray]:
    """The reference's 26 small-rotation perturbations (System.cpp:374-405)."""
    out = []
    for ax in trk_ops._ROT_AXES:
        q = np.array([1.0, *(rot * np.asarray(ax, np.float64))])
        q /= np.linalg.norm(q)
        pert = np.eye(4)
        pert[:3, :3] = lie.quat_to_rot(
            torch.tensor([q[1], q[2], q[3], q[0]], dtype=torch.float32)).numpy()
        out.append(pert)
    return out


def init_seed(wnd: W.Window, feats: FT.Feats, img0, u, v, cand_ok, idepth,
              exposure: float, cfg: Config, ext=None):
    """InitFromInitializer's numeric core (System.cpp:249-319): KF0 into
    slot 0 plus depth-prior'd active points, each linked to the nearest
    keypoint within 2.5 px when the indirect layer is on (`ext` holds KF0's
    extracted features). Returns (window, feats, n_points)."""
    dev = img0.device
    fr = {k: x.clone() for k, x in wnd.frames._asdict().items()}
    fr["valid"][0] = True
    fr["evalpt_R"][0] = torch.eye(3, device=dev)
    fr["evalpt_t"][0] = 0.0
    fr["state"][0] = 0.0
    fr["state_zero"][0] = 0.0
    fr["exposure"][0] = exposure
    fr["prior"][0] = torch.as_tensor(W.first_frame_prior(cfg), device=dev)
    fr["kf_id"][0] = 0
    fr["images"][0] = img0
    col, wgt, _gH, finite = KS.sample_pattern(img0, u, v, cfg)
    cand_ok = cand_ok & finite

    kp_link = torch.full_like(u, -1, dtype=torch.int32)
    if cfg.enable_indirect:
        feats = KS.feats_with_slot(feats, 0, ext)
        f_u, f_v, f_val = ext[0], ext[1], ext[5]
        d2 = (u[:, None] - f_u[None, :]) ** 2 + (v[:, None] - f_v[None, :]) ** 2
        d2 = torch.where(f_val[None, :], d2, torch.full_like(d2, float("inf")))
        nn = d2.argmin(dim=1)
        kp_link = torch.where(d2.amin(dim=1) <= 2.5 ** 2, nn, -1).to(torch.int32)

    pts = wnd.points
    slots, write = assign_free_slots(pts.status == W.PT_EMPTY, cand_ok)

    def put(arr, vals):
        return scatter_update(arr, slots, write, vals)

    pts = pts._replace(
        kp_idx=put(pts.kp_idx, kp_link),
        status=put(pts.status, torch.full_like(slots, W.PT_ACTIVE)),
        host=put(pts.host, torch.zeros_like(slots)),
        u=put(pts.u, u), v=put(pts.v, v), idepth=put(pts.idepth, idepth),
        idepth_zero=put(pts.idepth_zero, idepth), color=put(pts.color, col),
        weight=put(pts.weight, wgt),
        prior=put(pts.prior, torch.full_like(u, cfg.idepth_fix_prior)),
    )
    window = W.Window(frames=W.Frames(**fr), points=pts, HM=wnd.HM, bM=wnd.bM)
    return window, feats, cand_ok.sum()


class SLAMSystem:
    """Monocular hybrid direct-indirect SLAM engine on torch."""

    MAX_HYP = 32
    # mapping-queue depth beyond which the mapper fast-forwards to the
    # freshest frame (see _mapping_loop)
    CATCHUP_DRAIN = 8
    _POT_LADDER = (3, 4, 5, 6, 8)

    def __init__(self, fx, fy, cx, cy, width, height, cfg: Config = Config(),
                 enable_loop_closure: bool = True, sequential: bool = True,
                 online_photo_calib: bool = False, dist_mesh=None,
                 metrics_path: Optional[str] = None,
                 device: str | torch.device = "cuda"):
        unported = {
            "enable_loop_closure=True": enable_loop_closure,
            "online_photo_calib=True": online_photo_calib,
            "dist_mesh": dist_mesh is not None,
            "metrics_path": metrics_path is not None,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                "not ported to hslam_tpu_torch yet: " + ", ".join(bad))
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SLAMSystem runs on device={str(device)!r} and no CUDA device is "
                "available; pass device=\"cpu\" to run on the CPU, as the tests do")
        self.calib = make_calib(fx, fy, cx, cy, width, height, device=self.device)
        self.width, self.height = width, height
        self.n_relocs = 0            # successful PnP relocalizations
        self.window = W.empty_window(cfg, height, width, device=self.device)
        self.imm = KS.empty_imm(cfg, device=self.device)
        self.feats = FT.empty_feats(cfg.max_frames, cfg.max_kf_features, device=self.device)
        self.shells: List[Shell] = []
        self.kf_shell_ids: List[int] = []
        self.slot_shell: List[Optional[int]] = [None] * cfg.max_frames
        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        self.current_min_act_dist = 2.0
        self.last_coarse_rmse = np.full(5, 100.0)
        self.first_coarse_rmse = -1.0
        self.frame_count = 0
        self.next_kf_id = 0
        self.selector_pot = 5
        self._marg_counts: dict = {}
        self._last_flow = np.zeros(3)
        F = cfg.max_frames
        self._m_valid = np.zeros(F, bool)
        self._m_kfid = np.full(F, -1, np.int64)
        self._m_t = np.zeros((F, 3))
        self._m_aff = np.zeros((F, 2))
        self._m_exp = np.ones(F)
        self._m_nact_host = np.zeros(F, np.int64)
        self._m_nimm_host = np.zeros(F, np.int64)
        self._m_n_active = 0
        self.ind_obs_history: List[int] = []   # live indirect observations per KF
        self.template: Optional[trk_ops.Template] = None
        self.ref_slot = -1
        self.ref_shell_id = -1
        self.ref_aff = np.zeros(2)
        self.ref_exposure = 1.0
        self._init_first = None
        self._perts = _rot_perturbations()
        self._K_pyr_cache = k_pyr_from_value(self.calib.value, cfg.pyr_levels)

        # --- tracking/mapping threads (sequential=False): the mapping thread
        # consumes tracked frames; new tracker references come back through
        # the double buffer _pending_ref (System.cpp:127-133)
        self.sequential = sequential
        self._pending_ref = None          # (template, slot, shell_id, aff, exp)
        self._ref_lock = threading.Lock()
        self._shell_lock = threading.Lock()
        self._map_exc: Optional[BaseException] = None
        self.n_frames_skipped = 0         # non-KF frames dropped in catch-up
        self._need_kf_after = -1          # NeedNewKFAfter latch (shell id)
        self._catch_up = False
        self._pending_kf_final = None     # deferred keyframe finalization
        # lag-N pipelined tracking (process_frame_pipelined)
        self.pipeline_lag = 2
        self._pipe: deque = deque()
        self._frontier_frames = 0
        eye4 = torch.eye(4, device=self.device)
        self._dev_prev = eye4
        self._dev_prevprev = eye4
        self._dev_aff = torch.zeros(2, device=self.device)
        self._prev_ts = 0.0
        self._prevprev_ts = 0.0
        self.n_track_retries = 0          # batched-winner rejections
        # kf_latencies: dispatch to fresh template (what the tracker waits
        # on); kf_full_latencies: dispatch to the finalized bundle
        self.kf_latencies: deque = deque(maxlen=200)
        self.kf_full_latencies: deque = deque(maxlen=200)
        self._map_thread = None
        if not sequential:
            self._queue: deque = deque()
            self._qcond = threading.Condition()
            self._map_stop = False
            self._map_busy = False
            self._map_thread = threading.Thread(target=self._mapping_loop, daemon=True)
            self._map_thread.start()

    # ------------------------------------------------------------ helpers
    def _f32(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _select_px(self, pot, dir_img, grads, want, seed):
        """Candidate pixels: the gradient selector, or with cfg.use_fast
        FAST corners + grid NMS."""
        cfg = self.cfg
        if cfg.use_fast:
            score = orb_ops.fast_score(dir_img[..., 0], float(cfg.min_th_fast))
            u, v, valid = orb_ops.grid_nms(score, max(cfg.enforced_min_dist, 4),
                                           cfg.max_features)
            return u, v, torch.ones_like(u, dtype=torch.int32), valid
        status = sel_ops.select_pixels(dir_img, tuple(grads[:3]), pot, 1.0, seed, cfg)
        return sel_ops.compact_selection(status, grads[0], cfg.max_features, want, seed)

    def _raise_map_exc(self):
        if self._map_exc is not None:
            exc, self._map_exc = self._map_exc, None
            raise exc

    def _adopt_pending_ref(self):
        """Take a freshly published tracker reference (System.cpp:127-133)."""
        with self._ref_lock:
            if self._pending_ref is not None:
                (self.template, self.ref_slot, self.ref_shell_id,
                 self.ref_aff, self.ref_exposure) = self._pending_ref
                self._pending_ref = None
                self.first_coarse_rmse = -1.0

    def _new_shell(self, timestamp, exposure) -> Shell:
        shell = Shell(id=self.frame_count, timestamp=timestamp, exposure=exposure,
                      cam_to_world=np.eye(4), tracking_ref=None,
                      cam_to_ref=np.eye(4), aff=np.zeros(2))
        self.frame_count += 1
        self.shells.append(shell)
        return shell

    # ------------------------------------------------------------ main entry
    def process_frame(self, image: np.ndarray, timestamp: float,
                      exposure: float = 1.0) -> Shell:
        """ProcessNewFrame (System.cpp:104-247). `image`: (H, W) grayscale,
        uint8 or float, geometrically and photometrically corrected."""
        raw = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
        pyr, grads = build_direct_pyramid(raw, self.cfg.pyr_levels)
        shell = self._new_shell(timestamp, exposure)
        self._raise_map_exc()
        if not self.initialized:
            self._try_initialize(shell, pyr, grads)
            return shell
        self._adopt_pending_ref()
        if not self._track_new_coarse(shell, pyr):
            self.is_lost = True
            return shell
        need_kf = self._need_keyframe(shell)
        if self.sequential:
            if need_kf:
                self._add_keyframe(shell, pyr, grads)
            else:
                self._process_non_kf(shell, pyr)
        else:
            self._enqueue(shell, pyr, grads, need_kf)
        return shell

    def _enqueue(self, shell, pyr, grads, need_kf):
        """Hand a tracked frame to the mapping thread. Frames go untagged; a
        keyframe need only raises the NeedNewKFAfter latch (System.cpp:191-198)."""
        with self._qcond:
            if need_kf and shell.tracking_ref is not None:
                self._need_kf_after = max(self._need_kf_after, shell.tracking_ref)
            self._queue.append((shell, pyr, grads))
            self._qcond.notify_all()

    # ---------------------------------------------------- pipelined entry
    def process_frame_pipelined(self, image: np.ndarray, timestamp: float,
                                exposure: float = 1.0) -> Optional[Shell]:
        """Pipelined ProcessNewFrame: run this frame's fused tracking step,
        then finalize the frame `pipeline_lag` frames back. Returns the
        newly completed shell, or None. Needs sequential=False; call
        flush_pipeline() and finish() at the end of a sequence."""
        if self.sequential:
            raise RuntimeError("process_frame_pipelined needs sequential=False")
        self._raise_map_exc()
        cfg = self.cfg
        shell = self._new_shell(timestamp, exposure)
        if not self.initialized:
            self.flush_pipeline()
            raw = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
            pyr, grads = build_direct_pyramid(raw, cfg.pyr_levels)
            self._try_initialize(shell, pyr, grads)
            if self.initialized:
                # seed the device frontier at the second init keyframe
                self._frontier_frames = 0
                self._dev_prev = self._f32(shell.cam_to_world)
                self._dev_prevprev = self._dev_prev
                self._dev_aff = self._f32(shell.aff)
            return None

        self._adopt_pending_ref()
        with self._shell_lock:
            ref_c2w = self.shells[self.ref_shell_id].cam_to_world.copy()
        shell.tracking_ref = self.ref_shell_id
        # timestamp-gap ratio: under input skipping the constant-motion
        # hypothesis must cover several camera periods
        dt_prev = self._prev_ts - self._prevprev_ts
        dt_new = timestamp - self._prev_ts
        if self._frontier_frames >= 2 and dt_prev > 1e-9 and dt_new > 0:
            dt_ratio = float(np.clip(dt_new / dt_prev, 0.1, 32.0))
        else:
            dt_ratio = 1.0
        # the frame crosses to the device in its own dtype (uint8: 4x fewer
        # bytes); the pyramid casts it there
        raw = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
        out = trk_ops.track_step(
            self.template, raw, self.calib.value, self._f32(ref_c2w),
            self._dev_prev, self._dev_prevprev, self._frontier_frames >= 2,
            self._dev_aff, self._f32(self.ref_exposure), self._f32(shell.exposure),
            self._f32(self.ref_aff), cfg, cfg.pyr_levels, dt_ratio=dt_ratio)
        self._pipe.append((shell, out, raw))
        self._dev_prevprev = self._dev_prev
        self._dev_prev = out.c2w
        self._dev_aff = out.aff
        self._prevprev_ts = self._prev_ts
        self._prev_ts = timestamp
        self._frontier_frames += 1
        if len(self._pipe) > self.pipeline_lag:
            return self._complete_tracked(*self._pipe.popleft())
        return None

    def flush_pipeline(self):
        """Complete all in-flight pipelined frames."""
        out = None
        while self._pipe:
            out = self._complete_tracked(*self._pipe.popleft())
        return out

    @staticmethod
    def _pull_track(out):
        """One host pull of a tracking result (R, t, aff, ok, residuals,
        flow)."""
        flat = torch.cat([out.R.reshape(-1), out.t, out.aff, out.ok.float()[None],
                          out.residuals, out.flow]).cpu().numpy().astype(np.float64)
        L = out.residuals.shape[0]
        return (flat[:9].reshape(3, 3), flat[9:12], flat[12:14], flat[14] > 0.5,
                flat[15:15 + L], flat[15 + L:18 + L])

    def _complete_tracked(self, shell: Shell, out, raw) -> Shell:
        """Finalize one pipelined frame: pull the result, publish the pose,
        retry from a reset motion frontier if the batched winner was
        rejected (then relocalize, then keep the predicted pose), decide the
        keyframe and hand the frame to the mapping thread."""
        cfg = self.cfg
        R_h, t_h, aff_h, ok_h, res_h, flow_h = self._pull_track(out)    # host sync
        ok = ok_h and np.isfinite(res_h[0]) and np.all(np.isfinite(t_h))
        if ok:
            self.last_coarse_rmse = np.where(np.isnan(res_h), 100.0, np.minimum(res_h, 1e9))
            if self.first_coarse_rmse < 0:
                self.first_coarse_rmse = float(res_h[0])
            shell.cam_to_ref = np.linalg.inv(_se3_np(R_h, t_h))
            with self._shell_lock:
                shell.cam_to_world = self.shells[shell.tracking_ref].cam_to_world @ shell.cam_to_ref
            shell.aff = aff_h.copy()
            self._last_flow = flow_h.copy()
        else:
            # zero-motion hypotheses from the reference keyframe, through the
            # same track_step on the staged frame
            self.n_track_retries += 1
            with self._shell_lock:
                ref_c2w = self.shells[self.ref_shell_id].cam_to_world.copy()
            ref_dev = self._f32(ref_c2w)
            ref_aff = self._f32(self.ref_aff)
            out2 = trk_ops.track_step(
                self.template, raw, self.calib.value, ref_dev, ref_dev, ref_dev, False,
                ref_aff, self._f32(self.ref_exposure), self._f32(shell.exposure), ref_aff,
                cfg, cfg.pyr_levels, dt_ratio=1.0)
            R2, t2, aff2, ok2, res2, flow2 = self._pull_track(out2)       # host sync
            if ok2 and np.isfinite(res2[0]) and np.all(np.isfinite(t2)):
                self.last_coarse_rmse = np.where(np.isnan(res2), 100.0, np.minimum(res2, 1e9))
                shell.cam_to_ref = np.linalg.inv(_se3_np(R2, t2))
                with self._shell_lock:
                    shell.cam_to_world = ref_c2w @ shell.cam_to_ref
                shell.aff = aff2.copy()
                self._last_flow = flow2.copy()
            else:
                # recovery: PnP relocalization, else the predicted pose
                reloc = self._attempt_relocalization(shell, out.pyr)
                if reloc is not None:
                    self.n_relocs += 1
                    shell.relocalized = True
                    shell.cam_to_world = reloc
                else:
                    shell.pose_valid = False
                    shell.cam_to_world = ref_c2w
                shell.cam_to_ref = np.linalg.inv(ref_c2w) @ shell.cam_to_world
                shell.aff = np.asarray(self.ref_aff, np.float64).copy()
                self._last_flow = np.zeros(3)
            self._frontier_frames = 0
            self._dev_prev = self._f32(shell.cam_to_world)
            self._dev_prevprev = self._dev_prev
            self._dev_aff = self._f32(shell.aff)
        self._enqueue(shell, out.pyr, out.grads, self._need_keyframe(shell))
        return shell

    # ------------------------------------------------------ mapping thread
    def _mapping_loop(self):
        """Consumer of the tracked-frame queue, the reference's MappingThread
        policy (Mapping.cpp:143-214): the first two tracked frames after
        init are forced keyframes; while more frames wait, the popped one
        is traced as a non-keyframe (in catch-up a second one is dropped);
        the freshest frame becomes a keyframe iff the NeedNewKFAfter latch
        outlives the newest keyframe."""
        while True:
            with self._qcond:
                while not self._queue and not self._map_stop:
                    self._qcond.wait()
                if self._map_stop and not self._queue:
                    return
                shell, pyr, grads = self._queue.popleft()
                more = len(self._queue)
                self._map_busy = True
            try:
                if more > self.CATCHUP_DRAIN:
                    # severe overload: keep only the freshest frame
                    dropped = [shell]
                    with self._qcond:
                        while len(self._queue) > 1:
                            dropped.append(self._queue.popleft()[0])
                        shell, pyr, grads = self._queue.pop()
                        more = len(self._queue)
                    self._rebase_shells(dropped)
                    self.n_frames_skipped += len(dropped)
                if len(self.kf_shell_ids) <= 2:
                    # forced keyframes; the init gates are live, so synchronous
                    self._finalize_pending_kf()
                    t_kf = _time.perf_counter()
                    self._add_keyframe(shell, pyr, grads)
                    self.kf_latencies.append(_time.perf_counter() - t_kf)
                elif more > 0:
                    if more > 3:
                        self._catch_up = True
                    self._process_non_kf(shell, pyr)
                    self._finalize_pending_kf()
                    if self._catch_up:
                        # drop every second frame while behind (Mapping.cpp:177-192)
                        extra = None
                        with self._qcond:
                            if self._queue:
                                extra = self._queue.popleft()
                        if extra is not None:
                            self._rebase_shells([extra[0]])
                            self.n_frames_skipped += 1
                else:
                    newest_sid = self.kf_shell_ids[-1] if self.kf_shell_ids else -1
                    if self._need_kf_after >= newest_sid:
                        self._finalize_pending_kf()
                        t_kf = _time.perf_counter()
                        self._add_keyframe(shell, pyr, grads, defer=True)
                        self.kf_latencies.append(_time.perf_counter() - t_kf)
                        self._catch_up = False
                    else:
                        self._process_non_kf(shell, pyr)
                        self._finalize_pending_kf()
            except Exception as e:        # raised on the tracking thread
                self._map_exc = e
            finally:
                with self._qcond:
                    self._map_busy = False
                    self._qcond.notify_all()

    def _rebase_shells(self, shells):
        """Pose bookkeeping of frames the mapper drops."""
        with self._shell_lock:
            for sh in shells:
                if sh.tracking_ref is not None:
                    sh.cam_to_world = self.shells[sh.tracking_ref].cam_to_world @ sh.cam_to_ref

    def finish(self):
        """BlockUntilMappingIsFinished: drain the mapping queue and fold in a
        deferred keyframe finalization. No-op in sequential mode."""
        if self.sequential:
            return
        with self._qcond:
            while self._queue or self._map_busy:
                self._qcond.wait()
        self._raise_map_exc()
        self._finalize_pending_kf()

    def close(self):
        """Stop and join the mapping thread (after finish()). Raises a
        mapping-thread exception that was not raised yet."""
        if self._map_thread is not None:
            with self._qcond:
                self._map_stop = True
                self._qcond.notify_all()
            self._map_thread.join(timeout=60.0)
            if self._map_thread.is_alive():
                raise RuntimeError("mapping thread did not stop within 60 s")
            self._map_thread = None
        self._raise_map_exc()

    # ------------------------------------------------------------ bootstrap
    def _try_initialize(self, shell: Shell, pyr, grads):
        cfg = self.cfg
        if self._init_first is None or self.init_failed:
            self.init_failed = False
            u, v, _ptype, valid = self._select_px(
                self.selector_pot, pyr[0], grads, cfg.num_features, shell.id)
            self._init_first = dict(shell_id=shell.id, pyr=[p[..., 0] for p in pyr],
                                    dir0=pyr[0], u=u, v=v, valid=valid, fails=0)
            return
        first = self._init_first
        pts = torch.stack([first["u"], first["v"]], -1)
        tracked, ok, _err = klt_ops.track(first["pyr"], [p[..., 0] for p in pyr], pts)
        ok = ok & first["valid"]
        n_ok = int(ok.sum())                                     # host sync
        if n_ok < cfg.init_min_matches:
            first["fails"] += 1
            if first["fails"] > 40:
                self._init_first = None
            return
        flow = torch.sqrt(((tracked - pts) ** 2).sum(-1))
        flow_sum = float(torch.where(ok, flow, torch.zeros_like(flow)).sum())  # host sync
        mean_flow = flow_sum / max(n_ok, 1)
        if mean_flow < 0.05 * (self.width + self.height) * 0.5 * 0.1:
            return  # not enough parallax yet (Initializer.cpp:117-118)

        cv = self.calib.value.cpu().numpy()
        K = self._f32([[cv[0], 0, cv[2]], [0, cv[1], cv[3]], [0, 0, 1.0]])
        res = tv_ops.two_view_reconstruct(pts, tracked, ok, K, seed=shell.id,
                                          n_iters=cfg.init_ransac_iters)
        if not bool(res.ok):                                     # host sync
            first["fails"] += 1
            if first["fails"] > 40:
                self._init_first = None
            return
        # median-depth normalization to 1 (Initializer.cpp:142-148)
        z = res.points3d[:, 2].cpu().numpy().astype(np.float64)
        tri = res.tri_ok.cpu().numpy()
        med = np.median(z[tri]) if tri.sum() > 0 else 1.0
        scale = 1.0 / max(med, 1e-6)
        t_scaled = res.t.cpu().numpy().astype(np.float64) * scale
        R12 = res.R.cpu().numpy().astype(np.float64)
        idepth = 1.0 / np.maximum(z * scale, 1e-4)
        cand_ok = tri & (idepth > 0)

        # DirectRefinement: joint photometric polish of pose and idepths
        if cfg.init_direct_refine:
            ref = ir_ops.direct_refine(
                first["dir0"], pyr[0], first["u"], first["v"], first["valid"],
                self._f32(idepth), torch.as_tensor(tri, device=self.device),
                self._f32(R12), self._f32(t_scaled), self.calib.value, cfg)
            R_h, t_h, id_h, good_h = (x.cpu().numpy() for x in
                                      (ref.R, ref.t, ref.idepth, ref.good))  # host sync
            if np.all(np.isfinite(t_h)) and np.all(np.isfinite(R_h)):
                R12, t_scaled = R_h.astype(np.float64), t_h.astype(np.float64)
                # refined idepths for the triangulated survivors only
                keep = tri & good_h & np.isfinite(id_h)
                idepth = np.where(keep, id_h, idepth)
                cand_ok = tri & good_h & (idepth > 0)
        self._setup_from_init(first, shell, pyr, grads, R12, t_scaled, idepth, cand_ok)

    def _setup_from_init(self, first, shell, pyr, grads, R12, t12, idepth, ok_mask):
        """InitFromInitializer + the second frame as KF 1."""
        cfg = self.cfg
        first_shell = self.shells[first["shell_id"]]
        first_shell.cam_to_world = np.eye(4)
        first_shell.is_kf = True
        first_shell.kf_id = 0
        self.next_kf_id = 1
        T12 = _se3_np(R12, t12)
        shell.cam_to_world = np.linalg.inv(T12)
        shell.tracking_ref = first_shell.id
        shell.cam_to_ref = shell.cam_to_world.copy()
        self.slot_shell[0] = first_shell.id
        self.kf_shell_ids.append(first_shell.id)
        ext = KS.extract_feats(first["dir0"][..., 0], cfg) if cfg.enable_indirect else None
        self.window, self.feats, n_pts0_d = init_seed(
            self.window, self.feats, first["dir0"], first["u"], first["v"],
            torch.as_tensor(ok_mask, device=self.device), self._f32(idepth),
            float(first_shell.exposure or 1.0), cfg, ext)
        self.initialized = True
        self._init_first = None
        n_pts0 = int(n_pts0_d)                                   # host sync
        self._m_valid[:] = False
        self._m_valid[0] = True
        self._m_kfid[:] = -1
        self._m_kfid[0] = 0
        self._m_t[:] = 0.0
        self._m_aff[:] = 0.0
        self._m_exp[:] = 1.0
        self._m_exp[0] = first_shell.exposure or 1.0
        self._m_nact_host[:] = 0
        self._m_nact_host[0] = n_pts0
        self._m_nimm_host[:] = 0
        self._m_n_active = n_pts0
        self._add_keyframe(shell, pyr, grads)

    # ------------------------------------------------------------- tracking
    def _motion_hypotheses(self, anchor: Optional[int] = None):
        """Hypothesis list (System.cpp:347-405) + initial affine guess, read
        under the shell lock."""
        with self._shell_lock:
            ref_shell = self.shells[self.ref_shell_id]
            if anchor is None:
                anchor = len(self.shells) - 1
            tries = []
            if anchor >= 2 and self.shells[anchor - 1].pose_valid:
                slast = self.shells[anchor - 1]
                sprelast = self.shells[anchor - 2]
                if slast.relocalized or not sprelast.pose_valid:
                    T_sp = np.eye(4)
                else:
                    T_sp = np.linalg.inv(sprelast.cam_to_world) @ slast.cam_to_world
                    dt_prev = slast.timestamp - sprelast.timestamp
                    dt_new = self.shells[anchor].timestamp - slast.timestamp
                    if dt_prev > 1e-9 and dt_new > 0:
                        r = float(np.clip(dt_new / dt_prev, 0.1, 32.0))
                        if abs(r - 1.0) > 1e-6:
                            T_sp = _se3_exp_np(r * _se3_log_np(T_sp))
                T_ls = np.linalg.inv(slast.cam_to_world) @ ref_shell.cam_to_world
                inv = np.linalg.inv
                tries.append(inv(T_sp) @ T_ls)
                tries.append(inv(T_sp) @ inv(T_sp) @ T_ls)
                half = _se3_exp_np(0.5 * _se3_log_np(T_sp))
                tries.append(inv(half) @ T_ls)
                tries.append(T_ls)
                tries.append(np.eye(4))
                base = inv(T_sp) @ T_ls
                tries.extend(base @ p for p in self._perts)
                aff_init = self.shells[anchor - 1].aff.copy()
            else:
                tries.append(np.eye(4))
                aff_init = np.zeros(2)
        return tries, aff_init

    def _track_new_coarse(self, shell: Shell, pyr) -> bool:
        """trackNewCoarse: all hypotheses scored at the coarsest level in one
        batch, the argmin refined coarse-to-fine; the serial try-loop is the
        fallback when the batched winner is rejected."""
        tries, aff_init = self._motion_hypotheses()
        n = min(len(tries), self.MAX_HYP)
        T_all = np.stack(tries[:n] + [tries[0]] * (self.MAX_HYP - n))
        res, _best = trk_ops.track_coarse_multi(
            self.template, pyr, self._K_pyr_cache,
            self._f32(T_all[:, :3, :3]), self._f32(T_all[:, :3, 3]),
            self._f32(aff_init), self._f32(self.ref_exposure),
            self._f32(shell.exposure), self._f32(self.ref_aff), self.cfg,
            coarsest_lvl=self.cfg.pyr_levels - 1)
        R_h, t_h, aff_h, ok_h, res_h, flow_h = self._pull_track(res)    # host sync
        if ok_h and np.isfinite(res_h[0]):
            self.last_coarse_rmse = np.where(np.isnan(res_h), 100.0, np.minimum(res_h, 1e9))
            if self.first_coarse_rmse < 0:
                self.first_coarse_rmse = float(res_h[0])
            shell.cam_to_ref = np.linalg.inv(_se3_np(R_h, t_h))
            shell.tracking_ref = self.ref_shell_id
            shell.cam_to_world = self.shells[self.ref_shell_id].cam_to_world @ shell.cam_to_ref
            shell.aff = aff_h.copy()
            self._last_flow = flow_h.copy()
            return bool(np.all(np.isfinite(t_h)))
        return self._track_serial(shell, pyr, tries, aff_init)

    def _track_serial(self, shell: Shell, pyr, tries, aff_init) -> bool:
        """The reference's serial try-loop with achievedRes early exit
        (System.cpp:428-481), then relocalization."""
        cfg = self.cfg
        achieved = np.full(cfg.pyr_levels, np.nan)
        best = None
        have_good = False
        for T in tries:
            res = trk_ops.track_coarse(
                self.template, pyr, self._K_pyr_cache, self._f32(T[:3, :3]),
                self._f32(T[:3, 3]), self._f32(aff_init), self._f32(self.ref_exposure),
                self._f32(shell.exposure), self._f32(self.ref_aff), cfg,
                coarsest_lvl=cfg.pyr_levels - 1,
                min_res_for_abort=self._f32(np.where(np.isnan(achieved), np.inf, achieved)))
            r = res.residuals.cpu().numpy().astype(np.float64)      # host sync
            ok = bool(res.ok) and np.isfinite(r[0])
            if ok and (best is None or r[0] < achieved[0] or np.isnan(achieved[0])):
                best = res
                have_good = True
            if have_good:
                upd = np.isnan(achieved) | (achieved > r)
                achieved = np.where(upd & np.isfinite(r), r, achieved)
            if have_good and achieved[0] < self.last_coarse_rmse[0] * cfg.re_track_threshold:
                break

        if not have_good:
            ref_c2w = self.shells[self.ref_shell_id].cam_to_world
            shell.tracking_ref = self.ref_shell_id
            shell.aff = aff_init
            self._last_flow = np.zeros(3)
            reloc = self._attempt_relocalization(shell, pyr)
            if reloc is not None:
                self.n_relocs += 1
                shell.relocalized = True
                shell.cam_to_world = reloc
                shell.cam_to_ref = np.linalg.inv(ref_c2w) @ reloc
                return True
            shell.pose_valid = False
            shell.cam_to_ref = np.linalg.inv(tries[0])
            shell.cam_to_world = ref_c2w @ shell.cam_to_ref
            return True   # the reference hopes to recover; not lost unless NaN

        self.last_coarse_rmse = np.where(np.isnan(achieved), 100.0, np.minimum(achieved, 1e9))
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = float(achieved[0])
        R_b, t_b, aff_b, _, _, flow_b = self._pull_track(best)        # host sync
        shell.cam_to_ref = np.linalg.inv(_se3_np(R_b, t_b))
        shell.tracking_ref = self.ref_shell_id
        shell.cam_to_world = self.shells[self.ref_shell_id].cam_to_world @ shell.cam_to_ref
        shell.aff = aff_b.copy()
        self._last_flow = flow_b.copy()
        return bool(np.all(np.isfinite(t_b)))

    def _orb_features(self, img):
        """FAST + grid NMS + rBRIEF of one image (relocalization without the
        indirect layer)."""
        score = orb_ops.fast_score(img, float(self.cfg.min_th_fast))
        u, v, valid = orb_ops.grid_nms(score, 8, 512)
        ang = orb_ops.ic_angle(img, u, v)
        return u, v, valid, orb_ops.rbrief(gaussian_blur7(img), u, v, ang)

    def _attempt_relocalization(self, shell: Shell, pyr):
        """Pose recovery without the tracker: match the current frame's
        descriptors against the reference keyframe's, lift the keyframe's
        keypoints to 3D through the template's inverse depths and solve PnP
        RANSAC. Returns cam_to_world (4, 4) or None."""
        if self.template is None or self.ref_slot < 0:
            return None
        cfg = self.cfg
        cur_img = pyr[0][..., 0]
        if cfg.enable_indirect:
            # the reference keyframe's features were stored by its kf_step;
            # looser gates than the window matcher: PnP RANSAC rejects the rest
            feats = self.feats
            ku, kv = feats.u[self.ref_slot], feats.v[self.ref_slot]
            kval, kdesc = feats.valid[self.ref_slot], feats.desc[self.ref_slot]
            cu, cv, _, _, cdesc, cval = KS.extract_feats(cur_img, cfg)
            idx, ok = FT.match_pair(kdesc, kval, cdesc, cval, max_dist=80, ratio=0.9)
        else:
            ku, kv, kval, kdesc = self._orb_features(
                self.window.frames.images[self.ref_slot][..., 0])
            cu, cv, cval, cdesc = self._orb_features(cur_img)
            idx, ok = orb_ops.match_descriptors(kdesc, cdesc, valid_a=kval, valid_b=cval)
        if int(ok.sum()) < 15:                                   # host sync
            return None
        tpl = self.template
        tid, dmin = trk_ops.nearest_template_depth(ku, kv, tpl.u[0], tpl.v[0],
                                                   tpl.idepth[0], tpl.valid[0])
        valid = ok & (dmin <= 9.0)
        if int(valid.sum()) < 15:                                # host sync
            return None
        fx, fy, cx, cy = self.calib.value.cpu().numpy().astype(np.float64)
        z = 1.0 / torch.clamp(tid, min=1e-6)
        X_cam = torch.stack([(ku - cx) / fx * z, (kv - cy) / fy * z, z], -1)
        T_ref = self.shells[self.ref_shell_id].cam_to_world
        X_w = X_cam @ self._f32(T_ref[:3, :3]).T + self._f32(T_ref[:3, 3])
        obs = torch.stack([cu[idx], cv[idx]], -1)
        K = self._f32([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        # seeded with the zero-motion prediction from the reference: the DLT
        # samples alone degenerate on planar scenes
        T_pred = np.linalg.inv(T_ref)
        res = pnp_ops.solve_pnp(X_w, obs, valid, K, seed=shell.id,
                                init_R=self._f32(T_pred[:3, :3]),
                                init_t=self._f32(T_pred[:3, 3]))
        if not bool(res.ok):                                     # host sync
            return None
        return np.linalg.inv(_se3_np(res.R.cpu().numpy(), res.t.cpu().numpy()))

    def _need_keyframe(self, shell: Shell) -> bool:
        cfg = self.cfg
        if shell.relocalized:
            return True     # re-anchor the map at the recovered pose at once
        flow = self._last_flow
        a_rel = np.exp(shell.aff[0] - self.ref_aff[0]) * (
            shell.exposure / max(self.ref_exposure, 1e-6))
        wh = self.width + self.height
        metric = (
            cfg.kf_global_weight * cfg.kf_weight_shift_t * np.sqrt(max(flow[0], 0)) / wh
            + cfg.kf_global_weight * cfg.kf_weight_shift_r * np.sqrt(max(flow[1], 0)) / wh
            + cfg.kf_global_weight * cfg.kf_weight_shift_rt * np.sqrt(max(flow[2], 0)) / wh
            + cfg.kf_global_weight * cfg.max_affine_weight * abs(np.log(max(a_rel, 1e-6)))
        )
        return bool(metric > 1 or 2 * self.first_coarse_rmse < self.last_coarse_rmse[0])

    # ------------------------------------------------------------- non-KF
    def _process_non_kf(self, shell: Shell, pyr):
        """ProcessNonKeyframe: trace all candidates against this frame, with
        the pose recomputed from the (possibly BA-updated) reference."""
        with self._shell_lock:
            if shell.tracking_ref is not None:
                shell.cam_to_world = self.shells[shell.tracking_ref].cam_to_world @ shell.cam_to_ref
        Tw = np.linalg.inv(shell.cam_to_world)
        tr = KS.trace_candidates(
            self.imm, self.window.frames, self.calib.value, self._f32(Tw[:3, :3]),
            self._f32(Tw[:3, 3]), self._f32(shell.aff),
            self._f32(shell.exposure or 1.0), pyr[0], self.cfg)
        self.imm = self.imm._replace(trace=tr)

    # ------------------------------------------------------------- keyframe
    def _add_keyframe(self, shell: Shell, pyr, grads, defer: bool = False):
        """AddKeyframe: host policy on the mirrors, the keyframe step, the
        tracker reference published at once, then the bundle-dependent
        finalization (left pending when `defer`, after the init gates)."""
        cfg = self.cfg
        F = cfg.max_frames
        t0 = _time.perf_counter()
        shell.is_kf = True
        shell.kf_id = self.next_kf_id
        self.next_kf_id += 1
        if shell.tracking_ref is not None:
            with self._shell_lock:
                shell.cam_to_world = self.shells[shell.tracking_ref].cam_to_world @ shell.cam_to_ref
        flagged = self._flag_frames_for_marg(shell)
        flag_mask = np.zeros(F, bool)
        flag_mask[flagged] = True
        free = np.flatnonzero(~self._m_valid)
        if free.size == 0:
            raise RuntimeError("window full")
        slot = int(free[0])
        self._adapt_act_dist()
        n_valid_now = int(self._m_valid.sum()) + 1
        iters = cfg.max_opt_iterations
        if n_valid_now < 3:
            iters = 20
        elif n_valid_now < 4:
            iters = 15
        sel_u, sel_v, sel_type, sel_valid = self._select_px(
            self.selector_pot, pyr[0], grads, int(cfg.desired_immature_density), shell.id)
        # indirect-weight schedule: lean on the geometric terms (up to 3x)
        # when the photometric tracker runs worse than its own baseline
        if cfg.indirect_weight_schedule and self.first_coarse_rmse > 0:
            iw_scale = float(np.clip(
                self.last_coarse_rmse[0] / max(self.first_coarse_rmse, 1e-6), 1.0, 3.0))
        else:
            iw_scale = 1.0
        Twc = np.linalg.inv(shell.cam_to_world)
        window, calib, imm, feats, template, _result, bundle = KS.kf_step(
            self.window, self.calib, self.imm, self.feats, pyr, self._f32(Twc[:3, :3]),
            self._f32(Twc[:3, 3]), self._f32(shell.aff), self._f32(shell.exposure or 1.0),
            slot, shell.kf_id, self.ref_slot, flag_mask, float(self.current_min_act_dist),
            iters, sel_u, sel_v, sel_type, sel_valid, cfg, ind_w_scale=iw_scale)
        self.window, self.calib, self.imm, self.feats = window, calib, imm, feats
        self._K_pyr_cache = k_pyr_from_value(self.calib.value, cfg.pyr_levels)
        self.slot_shell[slot] = shell.id
        self.kf_shell_ids.append(shell.id)
        # publish the tracker reference now (the coarseTracker_forNewKF
        # double buffer); the BA-refined affine follows in _finalize_kf
        ref = (template, slot, shell.id, np.asarray(shell.aff, np.float64).copy(),
               shell.exposure or 1.0)
        if self.sequential:
            (self.template, self.ref_slot, self.ref_shell_id,
             self.ref_aff, self.ref_exposure) = ref
            self.first_coarse_rmse = -1.0
        else:
            with self._ref_lock:
                self._pending_ref = ref
        pending = (shell, slot, flag_mask, bundle, t0)
        if defer and self.next_kf_id > 4:
            self._pending_kf_final = pending     # init gates closed
        else:
            self._finalize_kf(pending)

    def _finalize_pending_kf(self):
        if self._pending_kf_final is not None:
            pending, self._pending_kf_final = self._pending_kf_final, None
            self._finalize_kf(pending)

    def _finalize_kf(self, pending):
        """The policy pull: init/lost gates, shell poses, policy mirrors,
        selector density adaptation, the reference's BA-refined affine."""
        cfg = self.cfg
        F = cfg.max_frames
        shell, slot, flag_mask, bundle, t0 = pending
        b = KS.KFBundle(*[x.cpu().numpy() for x in bundle])         # host sync
        rmse = float(b.rmse)
        nkf = self.next_kf_id
        if ((nkf == 2 and rmse > 20 * cfg.init_slack_factor)
                or (nkf == 3 and rmse > 13 * cfg.init_slack_factor)
                or (nkf == 4 and rmse > 9 * cfg.init_slack_factor)):
            self.init_failed = True
            self._reset()
            return
        if not np.isfinite(rmse):
            self.is_lost = True
            return
        published = b.valid | flag_mask
        with self._shell_lock:
            for s in range(F):
                if not published[s] or self.slot_shell[s] is None:
                    continue
                sh = self.shells[self.slot_shell[s]]
                sh.cam_to_world = np.linalg.inv(_se3_np(b.Rwc[s], b.twc[s]))
                sh.aff = np.asarray(b.aff[s], np.float64).copy()
        self._m_valid = np.asarray(b.valid).copy()
        self._m_kfid = np.asarray(b.kf_id, np.int64)
        self._m_t = np.asarray(b.twc, np.float64)
        self._m_aff = np.asarray(b.aff, np.float64)
        self._m_exp = np.asarray(b.exposure, np.float64)
        self._m_nact_host = np.asarray(b.n_active_host, np.int64)
        self._m_nimm_host = np.asarray(b.n_imm_host, np.int64)
        self._m_n_active = int(b.n_active)
        self.ind_obs_history.append(int(b.n_ind))
        self.kf_full_latencies.append(_time.perf_counter() - t0)
        for s in range(F):
            if flag_mask[s]:
                self.slot_shell[s] = None
                self._marg_counts[s] = 0
            elif int(b.removed_host[s]):
                self._marg_counts[s] = self._marg_counts.get(s, 0) + int(b.removed_host[s])
        if not cfg.use_fast:
            have = max(int(b.sel_count), 1)
            ideal = self.selector_pot * np.sqrt(have / cfg.desired_immature_density)
            self.selector_pot = min(self._POT_LADDER, key=lambda p: abs(p - ideal))
        aff_ba = np.asarray(b.aff[slot], np.float64).copy()
        with self._ref_lock:
            if self._pending_ref is not None and self._pending_ref[2] == shell.id:
                pr = self._pending_ref
                self._pending_ref = (pr[0], pr[1], pr[2], aff_ba, pr[4])
            elif self.ref_shell_id == shell.id:
                self.ref_aff = aff_ba

    def _adapt_act_dist(self):
        """Density feedback on currentMinActDist (Mapping.cpp:332-351)."""
        n_active = self._m_n_active
        target = self.cfg.desired_point_density
        d = self.current_min_act_dist
        if n_active < target * 0.66:
            d -= 0.8
        if n_active < target * 0.8:
            d -= 0.5
        elif n_active < target * 0.9:
            d -= 0.2
        elif n_active < target:
            d -= 0.1
        if n_active > target * 1.5:
            d += 0.8
        if n_active > target * 1.3:
            d += 0.5
        elif n_active > target * 1.15:
            d += 0.2
        elif n_active > target:
            d += 0.1
        self.current_min_act_dist = float(np.clip(d, 0.0, 4.0))

    def _flag_frames_for_marg(self, new_shell: Shell) -> List[int]:
        """flagFramesForMarginalization on the host mirrors."""
        cfg = self.cfg
        valid = self._m_valid
        slots = [s for s in range(cfg.max_frames) if valid[s]]
        kf_ids = self._m_kfid
        aff = self._m_aff
        exposure = self._m_exp
        flagged: List[int] = []
        newest_aff = new_shell.aff
        newest_exp = new_shell.exposure or 1.0
        for s in slots:
            n_in = int(self._m_nact_host[s] + self._m_nimm_host[s])
            n_out = int(self._marg_counts.get(s, 0))
            e = exposure[s] if exposure[s] else 1.0
            a_rel = np.exp(aff[s, 0] - newest_aff[0]) * (e / newest_exp)
            if ((n_in < cfg.min_points_remaining * max(n_in + n_out, 1)
                 or abs(np.log(max(a_rel, 1e-12))) > cfg.max_log_aff_fac_in_window)
                    and (len(slots) - len(flagged) > cfg.min_frames)):
                flagged.append(s)
        cap = min(cfg.max_kf_frames, cfg.max_frames - 1)
        T = self._m_t
        while len(slots) - len(flagged) >= cap:
            newest_kf = kf_ids[slots].max()
            best_score, best_slot = 1.0, None
            latest_slot = slots[int(np.argmax(kf_ids[slots]))]
            for s in slots:
                if s in flagged or kf_ids[s] > newest_kf - 1 or kf_ids[s] == 0:
                    continue
                dist_score = 0.0
                for s2 in slots:
                    if s2 == s or kf_ids[s2] > newest_kf:
                        continue
                    dist_score += 1.0 / (1e-5 + np.linalg.norm(T[s] - T[s2]))
                dist_score *= -np.sqrt(np.linalg.norm(T[s] - T[latest_slot]))
                if dist_score < best_score:
                    best_score, best_slot = dist_score, s
            if best_slot is None:
                break
            flagged.append(best_slot)
        return flagged

    def _reset(self):
        """Re-initialize after an init failure."""
        cfg = self.cfg
        self.window = W.empty_window(cfg, self.height, self.width, device=self.device)
        self.imm = KS.empty_imm(cfg, device=self.device)
        self.feats = FT.empty_feats(cfg.max_frames, cfg.max_kf_features, device=self.device)
        self._m_valid[:] = False
        self._m_kfid[:] = -1
        self._m_nact_host[:] = 0
        self._m_nimm_host[:] = 0
        self._m_n_active = 0
        self._marg_counts = {}
        self.initialized = False
        self.init_failed = False
        self._init_first = None
        self.slot_shell = [None] * cfg.max_frames
        self.next_kf_id = 0
        self.template = None
        with self._ref_lock:
            self._pending_ref = None
        self.ref_slot = -1
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = np.full(5, 100.0)

    def trajectory(self):
        """All frame poses (camToWorld) for export."""
        return [(s.timestamp, s.cam_to_world[:3, :3], s.cam_to_world[:3, 3])
                for s in self.shells]
