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

Loop closure (`enable_loop_closure`, on by default): every finalized
keyframe becomes an entry of the `LoopCloser` (its stored features, or FAST +
rBRIEF of its image without the indirect layer, with keypoint inverse
depths), excluded from matching against the keyframes it shares residuals
with (`connectivity`). Detection, verification and the pose-graph relaxation
run inline (`sequential=True`) or on a loop-closure worker thread, which
leaves its numbered corrections in `_lc_corrs` for the mapping thread to
apply between keyframe steps: one gauge transform for the whole window.

Threads and the device: the tracking thread (the caller), the mapping thread
and the loop-closure worker enqueue their work on the same CUDA stream (the
default one), so every tensor one thread hands to another was written by
operations enqueued before it was handed over; no event or `record_stream`
is needed. State shared between the threads is replaced, never mutated in
place (the keypoint store, the window, the calibration). A mapping-thread
exception is raised on the tracking thread at its next call, by `finish`
or by `close`; a worker exception by `finish` or `close`.

Online photometric calibration (`online_photo_calib`): frames arrive raw;
every `photo_calib_every`-th tracked frame the template is warped into the
last frames, their raw intensities sampled and response, vignette and
exposures fitted jointly on the device (models/photo_calib.py). From the
first fit on, each frame is corrected (inverse response and vignette) before
its pyramid and its gradients are re-weighted by the response's derivative;
the state built from uncorrected frames is re-corrected once (the template
by the tracking thread, the window at the next keyframe step), and later
fits are blended into the correction. `metrics_path` streams JSONL records:
one "frame" per tracked frame of `process_frame`, one "kf" and one "map"
(the window's point cloud) per keyframe.

`dist_mesh` (a `parallel.distributed.Mesh`): the windowed BA and the point
marginalization run point-sharded over its ranks, and the loop closer's
matrix-free pose graph edge-sharded over a group of its own. Every rank
runs this same system over the same frames (parallel/__init__.py). The
sequential entry is replicated: each rank makes every decision itself. The
threaded entries (`sequential=False`) on more than one rank run in lockstep:
rank 0 tracks and makes each decision that depends on thread timing, and
the other ranks replay it from two control channels (Gloo groups of their
own, parallel/distributed.Channel):
  * the tracking thread's: one record per call of an entry (initialize this
    frame, or a tracked frame's pose, reference, affine, validity, keyframe
    need and tracker residuals), then the calibration fit's state when one
    landed. A follower builds each frame's pyramid itself (the same frame
    and correction give the same bits), runs no tracking, writes the record
    into its shell, holds the tracking reference rank 0 holds (its own
    mapping thread's publication of the keyframe the record names, so that
    it can be checkpointed as rank 0 is) and enqueues what rank 0 enqueued;
  * the mapping thread's: one decision per step (the frames it pops, drops
    or traces, whether it keyframes, the loop correction it folds in first,
    the calibration re-sync and the tracker state a keyframe step reads).
    A follower waits until those frames are in its queue (and the correction
    from its own worker) and runs the step as told, so the sharded BA's
    collectives come in the same order on every rank.
The loop-closure worker needs no record: its entries come from the mapping
thread in lockstep, with the intrinsics of their keyframe step. Every rank
ends with the same trajectory, bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time as _time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..config import PATTERN, Config
from ..models import kf_step as KS
from ..models import photo_calib as PC
from ..models import window as W
from ..models.calib import k_pyr_from_value, make_calib
from ..models.loop_closure import LoopCloser
from ..ops import bow as bow_ops
from ..ops import features as FT
from ..ops import init_refine as ir_ops
from ..ops import klt as klt_ops
from ..ops import orb as orb_ops
from ..ops import pnp as pnp_ops
from ..ops import selector as sel_ops
from ..ops import tracker as trk_ops
from ..ops import twoview as tv_ops
from ..ops.pyramid import build_direct_pyramid, gaussian_blur7, image_gradients
from ..ops.undistort import invert_response, photometric_correct, response_grad_weight
from ..parallel.distributed import Channel
from ..utils import lie
from ..utils.compaction import assign_free_slots, scatter_update
from ..utils.interp import bilinear, bilinear_stack


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


def default_vocab_path() -> Optional[str]:
    """The shipped 10^4-word BoW vocabulary: a data file of the JAX package
    (hslam_tpu/assets/vocab_10k.npz, trained on diverse generated scenes),
    read in place by path. None if the file is missing; callers then fall
    back to online training."""
    p = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "hslam_tpu", "assets", "vocab_10k.npz")
    return p if os.path.exists(p) else None


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


def map_cloud(frames: W.Frames, points: W.Points, calib_value):
    """World-space position of every point slot, its validity and its centre
    colour: the live-map feed (Src/Display.cpp:382-441, with the noise
    filter of :409-421; depth-prior'd bootstrap points keep
    max_rel_baseline 0 and pass through their prior)."""
    fx, fy, cx, cy = calib_value[0], calib_value[1], calib_value[2], calib_value[3]
    R, t = W.frame_poses(frames)                       # worldToCam
    z = 1.0 / torch.clamp(points.idepth, min=1e-6)
    pc = torch.stack([(points.u - cx) / fx * z, (points.v - cy) / fy * z, z], -1)
    host = torch.clamp(points.host.long(), 0, R.shape[0] - 1)
    xyz = torch.einsum("pji,pj->pi", R[host], pc - t[host])
    id_var = 1.0 / (points.idepth_hessian + 0.01)
    ok = ((points.status == W.PT_ACTIVE) & (points.idepth > 1e-6)
          & ((points.max_rel_baseline >= 0.01) | (points.prior > 0))
          & (id_var <= 1e-2 * z * z * z * z))
    return xyz, ok, points.color[:, 4]


# Lockstep control records (rank 0 -> the other ranks of a mesh). Tracking
# thread, one per call of an entry and per completed frame: a head (this
# call initializes; a pipelined call, with the frame it completed if any),
# a completed frame (by flush_pipeline or process_frame), a lost frame, and
# the marks of flush_pipeline, finish and close.
R_INIT, R_STEP, R_DONE, R_LOST, R_FLUSH, R_FINISH, R_END = range(1, 8)
# mapping thread, one per step; its actions
M_STEP, M_END = 1, 2
KF_FORCED, TRACE, KF_DEFER = 0, 1, 2
MAP_FIELDS = (("kind", ()), ("sid", ()), ("n_drop", ()), ("action", ()), ("extra", ()),
              ("corr", ()), ("ref_slot", ()), ("iw_scale", ()), ("resync_fit", ()))
# how long a follower waits for what rank 0's record names (its own queued
# frames, its worker's correction, its tracking thread's fit)
REPLAY_TIMEOUT_S = 600.0


def _n_rmse(cfg: Config) -> int:
    """Room for the tracker's residuals: one per level (5 before a frame
    was tracked)."""
    return max(5, cfg.pyr_levels)


def track_fields(cfg: Config):
    """The tracking thread's record: a frame's shell and tracker state
    (`rmse` holds the tracker's per-level residuals, `rmse_n` of them;
    `tref` is the keyframe whose reference rank 0 holds as the record
    leaves, which on the pipelined entry may be newer than the completed
    frame's `ref`; `fit_pend` the staged reference that a first fit
    re-corrected, -1 if none)."""
    return (("kind", ()), ("sid", ()), ("c2w", (4, 4)), ("c2r", (4, 4)), ("ref", ()),
            ("aff", (2,)), ("valid", ()), ("reloc", ()), ("retried", ()), ("need_kf", ()),
            ("rmse", (_n_rmse(cfg),)), ("rmse_n", ()), ("first_rmse", ()),
            ("flow", (3,)), ("fit", ()), ("tref", ()), ("fit_pend", ()))


def _control_channels(mesh, cfg: Config):
    """The tracking and mapping threads' channels on a mesh of more than one
    rank (both None otherwise: a world of one sends nothing)."""
    if mesh is None or mesh.size == 1:
        return None, None
    return Channel(track_fields(cfg), mesh), Channel(MAP_FIELDS, mesh)


class SLAMSystem:
    """Monocular hybrid direct-indirect SLAM engine on torch."""

    MAX_HYP = 32
    # mapping-queue depth beyond which the mapper fast-forwards to the
    # freshest frame (see _mapping_loop)
    CATCHUP_DRAIN = 8
    _POT_LADDER = (3, 4, 5, 6, 8)

    def __init__(self, fx, fy, cx, cy, width, height, cfg: Config = Config(),
                 enable_loop_closure: bool = True, sequential: bool = True,
                 online_photo_calib: bool = False, photo_calib_every: int = 8,
                 dist_mesh=None, vocab_path: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 device: str | torch.device = "cuda"):
        """`online_photo_calib`: frames are raw; response, vignette and
        exposures are fitted online every `photo_calib_every` tracked frames
        (exposures passed to the entries pin the fit's gauge).

        `vocab_path`: the BoW vocabulary of loop closure (.npz of
        ops.bow.save_vocabulary). The default (None) loads the shipped
        10^4-word vocabulary; "online" trains a small one from the first 8
        keyframes of the run instead; anything else is a path to your own.

        `metrics_path`: a JSONL stream of "frame", "kf" and "map" records
        (one json.dumps per record, no extra device pulls but the map
        record's point cloud).

        `dist_mesh` (optional `parallel.distributed.Mesh`, made on every
        rank, which all run this constructor with the same arguments and
        make the same calls with the same frames): point-shard the windowed
        BA and the point marginalization over the mesh; cfg.max_points must
        divide into the mesh size. With `sequential=False` on more than one
        rank, rank 0 tracks and decides and the other ranks replay (see the
        module's docstring); a rank that finds no record raises."""
        if dist_mesh is not None and cfg.max_points % dist_mesh.size:
            raise ValueError(f"max_points {cfg.max_points} does not divide into "
                             f"the mesh size {dist_mesh.size}")
        self.dist_mesh = dist_mesh
        # the loop closer's pose graph may run on the worker thread while the
        # mapping thread's BA uses dist_mesh: a group of its own
        self._edge_mesh = None if dist_mesh is None else dist_mesh.split("edges")
        # the threaded entries' control channels (rank 0 -> the others)
        self._trk, self._map = ((None, None) if sequential
                                else _control_channels(dist_mesh, cfg))
        self._follower = self._trk is not None and not self._trk.leader
        self._trk_ended = False           # a follower got rank 0's end mark
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SLAMSystem runs on device={str(device)!r} and no CUDA device is "
                "available; pass device=\"cpu\" to run on the CPU, as the tests do")
        self.calib = make_calib(fx, fy, cx, cy, width, height, device=self.device)
        self.width, self.height = width, height
        self.enable_loop_closure = enable_loop_closure
        # online photometric calibration; the correction (inverse response,
        # inverse vignette, gradient weight) is one tuple, replaced whole
        self.online_photo_calib = online_photo_calib
        self.photo_calib_every = photo_calib_every
        self._pc_blend = 0.3                # refit blend rate
        self._pc_ring: deque = deque(maxlen=photo_calib_every)   # (shell id, raw frame)
        self._pc_params: Optional[PC.PhotoParams] = None
        self._pc_rms: Optional[torch.Tensor] = None   # device scalar
        self._pc_luts = None                # (inv_response, inv_vignette, grad_weight)
        self._pc_window_resync = False      # first fit landed: the mapping thread
                                            # re-corrects the window at its next keyframe
        self.n_photo_fits = 0
        # guards the fit's publication against the mapping thread's read of
        # the re-sync; a follower keeps each fit's correction until the
        # re-sync rank 0 names has run
        self._pc_cond = threading.Condition()
        self._pc_luts_hist: dict = {}
        self.loop_closer: Optional[LoopCloser] = None   # built once a vocabulary exists
        self._vocab_descs: list = []      # descriptor pool for online training
        self._pending_entries: list = []  # keyframe entries awaiting the vocabulary
        if vocab_path is None:
            vocab_path = default_vocab_path()
        elif vocab_path == "online":
            vocab_path = None
        if enable_loop_closure and vocab_path is not None:
            self.loop_closer = self._make_loop_closer(
                bow_ops.load_vocabulary(vocab_path, device=self.device))
        self.n_loops_closed = 0
        self.n_relocs = 0            # successful PnP relocalizations
        self._metrics_f = open(metrics_path, "w") if metrics_path else None
        self._metrics_lock = threading.Lock()
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
        # keyframe connectivity map:
        # (host_kf_id, target_kf_id) -> [n_active_res, n_marginalized_res]
        self.connectivity: dict = {}
        self.ind_obs_history: List[int] = []   # live indirect observations per KF
        self._newest_template: Optional[trk_ops.Template] = None
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
        # a follower adopts the reference each record names: its mapping
        # thread's publications kept by shell id until a record names a newer
        # one, and the one rank 0's first fit re-corrected while it was staged
        # (shell id, inv_response, inv_vignette) if not yet published here
        self._ref_cond = threading.Condition(self._ref_lock)
        self._pub_refs: dict = {}
        self._pc_fix_ref = None
        self._pc_pend_fixed = -1          # rank 0: that staged reference's shell id
        self._shell_lock = threading.Lock()
        self._map_exc: Optional[BaseException] = None
        # the loop-closure worker's failures get a slot of their own: a
        # concurrent mapping-thread exception must not overwrite one
        self._lc_exc: Optional[BaseException] = None
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
        self.lc_detect_ms: deque = deque(maxlen=200)
        # loop-closure worker (sequential=False): BoW, PnP and the pose graph
        # run off the mapping thread; corrections come back numbered through
        # _lc_corrs and are applied between keyframe steps
        self._lc_thread = None
        self._lc_corrs: dict = {}          # correction number -> {shell_id: cam_to_world}
        self._lc_n_corrs = 0
        self._lc_corr_cond = threading.Condition()
        self._map_thread = None
        self._map_broken = False          # the mapping thread ended on a broken control stream
        if not sequential:
            self._queue: deque = deque()
            self._qcond = threading.Condition()
            self._map_stop = False
            self._map_busy = False
            self._map_thread = threading.Thread(target=self._mapping_loop, daemon=True)
            self._map_thread.start()
            if enable_loop_closure:
                self._lc_queue: deque = deque()
                self._lc_cond = threading.Condition()
                self._lc_stop = False
                self._lc_busy = False
                self._lc_thread = threading.Thread(target=self._lc_loop, daemon=True)
                self._lc_thread.start()

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
        uint8 or float, geometrically corrected; photometrically corrected
        too unless online_photo_calib is on (then raw intensities)."""
        raw = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
        pyr, grads = self._pyramid(raw)
        shell = self._new_shell(timestamp, exposure)
        self._raise_map_exc()
        if self._follower:
            rec = self._recv_frame(R_INIT, R_DONE, R_LOST)
            init = rec["kind"] == R_INIT
        else:
            init = not self.initialized
            if init:
                self._send_frame(R_INIT)
        if init:
            self._lockstep_idle()
            self._try_initialize(shell, pyr, grads)
            return shell
        if self._follower:
            need_kf = self._apply_frame(shell, rec)
            ok = rec["kind"] == R_DONE
        else:
            self._adopt_pending_ref()
            ok = self._track_new_coarse(shell, pyr)
            fit = ok and self.online_photo_calib and self._pc_observe(shell.id, raw)
            need_kf = ok and self._need_keyframe(shell)
            self._send_frame(R_DONE if ok else R_LOST, shell, need_kf, fit=fit)
        if not ok:
            self.is_lost = True
            return shell
        self._emit_metrics(
            t="frame", id=shell.id, ts=timestamp, kf=bool(need_kf),
            rmse=float(self.last_coarse_rmse[0]), pose_valid=bool(shell.pose_valid),
            reloc=bool(shell.relocalized),
            p=[round(float(x), 4) for x in shell.cam_to_world[:3, 3]])
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

    # ------------------------------------------------ lockstep (a mesh)
    def _send_frame(self, kind, shell: Optional[Shell] = None, need_kf=False,
                    retried=False, fit=False):
        """Rank 0: one tracking record, `shell`'s (a bare mark without one),
        then the fit's state when a fit landed with this frame. A no-op off
        a mesh."""
        if self._trk is None or self._trk_ended:
            return
        rmse = np.zeros(_n_rmse(self.cfg))
        rmse[:len(self.last_coarse_rmse)] = self.last_coarse_rmse
        rec = dict(kind=kind, sid=-1, c2w=np.eye(4), c2r=np.eye(4), ref=-1, aff=np.zeros(2),
                   valid=True, reloc=False, retried=retried, need_kf=need_kf, rmse=rmse,
                   rmse_n=len(self.last_coarse_rmse), first_rmse=self.first_coarse_rmse,
                   flow=self._last_flow, fit=fit, tref=self.ref_shell_id,
                   fit_pend=self._pc_pend_fixed if fit else -1)
        if shell is not None:
            with self._shell_lock:
                c2w = shell.cam_to_world.copy()
            rec.update(sid=shell.id, c2w=c2w, c2r=shell.cam_to_ref, aff=shell.aff,
                       ref=-1 if shell.tracking_ref is None else shell.tracking_ref,
                       valid=shell.pose_valid, reloc=shell.relocalized)
        self._trk.send(**rec)
        if fit:
            self._trk.send_tensors([*self._pc_params, self._pc_rms, *self._pc_luts])
        if kind == R_END:
            self._trk_ended = True

    def _recv_frame(self, *kinds) -> dict:
        """A follower: rank 0's next tracking record, which must be of one of
        `kinds`; rank 0's end mark (it closed, or failed) raises."""
        if self._trk_ended:
            raise RuntimeError("rank 0 has ended the tracking stream")
        rec = self._trk.recv()
        if rec["kind"] == R_END:
            self._trk_ended = True
            raise RuntimeError("rank 0 ended the tracking stream (closed or failed) "
                               "while this rank was still running its frames")
        if rec["kind"] not in kinds:
            raise RuntimeError(f"rank 0 sent a record of kind {int(rec['kind'])} where "
                               f"this rank expects one of {kinds}: the ranks' calls differ")
        return rec

    def _apply_frame(self, shell: Shell, rec: dict) -> bool:
        """A follower: write rank 0's record of this frame into its shell and
        tracker state (and the fit that landed with it); returns the keyframe
        need."""
        if int(rec["sid"]) != shell.id:
            raise RuntimeError(f"rank 0 sent frame {int(rec['sid'])}'s record for frame "
                               f"{shell.id}: the ranks' calls differ")
        self._follow_ref(rec)
        shell.tracking_ref = None if rec["ref"] < 0 else int(rec["ref"])
        shell.cam_to_ref = rec["c2r"]
        with self._shell_lock:
            shell.cam_to_world = rec["c2w"]
        shell.aff = rec["aff"]
        shell.pose_valid, shell.relocalized = bool(rec["valid"]), bool(rec["reloc"])
        self.n_relocs += int(rec["reloc"])
        self.n_track_retries += int(rec["retried"])
        self.last_coarse_rmse = rec["rmse"][:int(rec["rmse_n"])]
        self._last_flow = rec["flow"]
        if rec["fit"]:
            self._pc_apply_fit(self._trk.recv_tensors(self.device), int(rec["fit_pend"]))
        return bool(rec["need_kf"])

    def _follow_ref(self, rec: dict):
        """A follower: hold the reference rank 0 holds as of this record, its
        own mapping thread's publication of that keyframe (waited for),
        taken as _adopt_pending_ref takes one on rank 0; older publications
        are dropped. The first residual is rank 0's, not reset."""
        sid = int(rec["tref"])
        if sid >= 0 and sid != self.ref_shell_id:
            with self._ref_cond:
                if not self._ref_cond.wait_for(
                        lambda: sid in self._pub_refs or self._map_exc is not None,
                        timeout=REPLAY_TIMEOUT_S):
                    raise TimeoutError(f"rank 0 tracks against frame {sid}'s reference, "
                                       "which this rank never published")
                ref = self._pub_refs.get(sid)
                if ref is not None:
                    (self.template, self.ref_slot, self.ref_shell_id,
                     self.ref_aff, self.ref_exposure) = ref
                    for k in [k for k in self._pub_refs if k < sid]:
                        del self._pub_refs[k]
            if ref is None:               # the mapping thread failed first
                self._raise_map_exc()
        self.first_coarse_rmse = rec["first_rmse"]

    def _lockstep_idle(self):
        """Before a (re-)initialization on a mesh: let the mapping thread
        finish its steps, whose collectives share the keyframe step's group
        with the initialization's."""
        if self._trk is not None:
            self._wait_mapping_idle()

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
        shell = self._new_shell(timestamp, exposure)
        if self._follower:
            rec = self._recv_frame(R_INIT, R_STEP)
            init = rec["kind"] == R_INIT
        else:
            init = not self.initialized
            if init:
                self._send_frame(R_INIT)
        if init:
            if self._pipe:
                self.flush_pipeline()
            self._lockstep_idle()
            raw = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
            pyr, grads = self._pyramid(raw)
            self._try_initialize(shell, pyr, grads)
            if self.initialized:
                # seed the device frontier at the second init keyframe
                self._frontier_frames = 0
                self._dev_prev = self._f32(shell.cam_to_world)
                self._dev_prevprev = self._dev_prev
                self._dev_aff = self._f32(shell.aff)
            return None
        # the frame crosses to the device in its own dtype (uint8: 4x fewer
        # bytes); the pyramid casts it there
        raw = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
        if self._follower:
            # no tracking here: the reference rank 0 took for this frame, this
            # frame's pyramid, and rank 0's record of the frame it completed
            self._follow_ref(rec)
            self._pipe.append((shell, self._pyramid(raw)))
            if rec["sid"] >= 0:
                return self._complete_replayed(*self._pipe.popleft(), rec)
            if len(self._pipe) > self.pipeline_lag:
                raise RuntimeError("rank 0 completed no frame where this rank would")
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
        out = self._track_step(raw, self._f32(ref_c2w), self._dev_prev, self._dev_prevprev,
                               self._frontier_frames >= 2, self._dev_aff, shell.exposure,
                               dt_ratio)
        self._pipe.append((shell, out, raw))
        self._dev_prevprev = self._dev_prev
        self._dev_prev = out.c2w
        self._dev_aff = out.aff
        self._prevprev_ts = self._prev_ts
        self._prev_ts = timestamp
        self._frontier_frames += 1
        if len(self._pipe) > self.pipeline_lag:
            return self._complete_tracked(*self._pipe.popleft(), kind=R_STEP)
        self._send_frame(R_STEP)
        return None

    def flush_pipeline(self):
        """Complete all in-flight pipelined frames."""
        out = None
        while self._pipe:
            if self._follower:
                out = self._complete_replayed(*self._pipe.popleft(), self._recv_frame(R_DONE))
            else:
                out = self._complete_tracked(*self._pipe.popleft())
        if self._follower:
            self._recv_frame(R_FLUSH)
        else:
            self._send_frame(R_FLUSH)
        return out

    def _complete_replayed(self, shell: Shell, pyr_grads, rec: dict) -> Shell:
        """A follower's _complete_tracked: rank 0's record, then the frame
        with this rank's own pyramid to the mapping thread."""
        need_kf = self._apply_frame(shell, rec)
        self._enqueue(shell, *pyr_grads, need_kf)
        return shell

    @staticmethod
    def _pull_track(out):
        """One host pull of a tracking result (R, t, aff, ok, residuals,
        flow)."""
        flat = torch.cat([out.R.reshape(-1), out.t, out.aff, out.ok.float()[None],
                          out.residuals, out.flow]).cpu().numpy().astype(np.float64)
        L = out.residuals.shape[0]
        return (flat[:9].reshape(3, 3), flat[9:12], flat[12:14], flat[14] > 0.5,
                flat[15:15 + L], flat[15 + L:18 + L])

    def _complete_tracked(self, shell: Shell, out, raw, kind=R_DONE) -> Shell:
        """Finalize one pipelined frame: pull the result, publish the pose,
        retry from a reset motion frontier if the batched winner was
        rejected (then relocalize, then keep the predicted pose), decide the
        keyframe and hand the frame to the mapping thread (on a mesh, after
        the record of `kind` to the other ranks)."""
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
            out2 = self._track_step(raw, ref_dev, ref_dev, ref_dev, False,
                                    self._f32(self.ref_aff), shell.exposure, 1.0)
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
        fit = self.online_photo_calib and self._pc_observe(shell.id, raw)
        need_kf = self._need_keyframe(shell)
        self._send_frame(kind, shell, need_kf, retried=not ok, fit=fit)
        self._enqueue(shell, out.pyr, out.grads, need_kf)
        return shell

    def _track_step(self, raw, ref_c2w, prev_c2w, prevprev_c2w, have_motion, aff0,
                    exposure, dt_ratio):
        """The fused per-frame tracking step on the staged frame, against
        the current template; with the online calibration's correction once
        a fit exists (the correction, then the pyramid with the gradient
        weight, as the sequential entry builds it)."""
        cfg = self.cfg
        img, grad_w = raw, None
        luts = self._pc_luts
        if luts is not None:
            inv_resp, inv_vig, grad_w = luts
            img = photometric_correct(raw.to(torch.float32), inv_resp, inv_vig)
        return trk_ops.track_step(
            self.template, img, self.calib.value, ref_c2w, prev_c2w, prevprev_c2w,
            have_motion, aff0, self._f32(self.ref_exposure), self._f32(exposure),
            self._f32(self.ref_aff), cfg, cfg.pyr_levels, gamma_grad_weight=grad_w,
            dt_ratio=dt_ratio)

    # ------------------------------------------- online photometric calibration
    def _pyramid(self, raw):
        """The frame's pyramid, through the calibrated correction once the
        online calibration has made its first fit."""
        luts = self._pc_luts
        if luts is None:
            return build_direct_pyramid(raw, self.cfg.pyr_levels)
        return self._prep_calibrated(raw, *luts)

    def _prep_calibrated(self, raw, inv_resp, inv_vig, grad_w):
        """Photometric correction, then the pyramid with the response's
        gradient weight (photometricUndistorter.cpp:121-146, Frame.cpp:158-164).
        Corrected intensities run past 255 where 1/V > 1; the weight's index
        is clamped in the pyramid."""
        img = photometric_correct(raw.to(torch.float32), inv_resp, inv_vig)
        return build_direct_pyramid(img, self.cfg.pyr_levels, gamma_grad_weight=grad_w)

    def _pc_observe(self, shell_id: int, raw) -> bool:
        """Ring the tracked frame's raw image; refit every photo_calib_every
        frames once the ring is full. True if a fit landed."""
        self._pc_ring.append((shell_id, raw))
        return (len(self._pc_ring) == self._pc_ring.maxlen
                and shell_id % self.photo_calib_every == 0 and self._photo_calib_step())

    def _pc_sample(self, u, v, idepth, valid, K4, R_rel, t_rel, raws):
        """Raw intensities of the template points (u, v, idepth, valid: (P,))
        warped into each ring frame (R_rel, t_rel: (F, 3, 3), (F, 3) from the
        reference; raws (F, H, W), any dtype). Returns obs, r2, mask (P, F)."""
        raws = raws.to(torch.float32)
        fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
        Hh, Ww = raws.shape[1], raws.shape[2]
        dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
        p3 = (torch.einsum("fij,pj->fpi", R_rel, dirs)
              + t_rel[:, None, :] * idepth[None, :, None])          # (F, P, 3)
        z = torch.where(p3[..., 2].abs() < 1e-9, 1e-9, p3[..., 2])
        uu = fx * p3[..., 0] / z + cx
        vv = fy * p3[..., 1] / z + cy
        inb = (z > 0) & (uu > 1) & (vv > 1) & (uu < Ww - 2) & (vv < Hh - 2)
        obs = bilinear_stack(raws, uu, vv)                           # (F, P)
        ccx, ccy = (Ww - 1) / 2.0, (Hh - 1) / 2.0
        r2 = ((uu - ccx) ** 2 + (vv - ccy) ** 2) / (ccx * ccx + ccy * ccy)
        mask = inb & valid[None, :] & torch.isfinite(obs)
        return obs.T, r2.T, mask.T

    def _pc_fit(self, obs, r2, mask, exp, known: bool, params0=None):
        """The joint response / vignette / exposure fit and the correction
        derived from it. `known` pins the log exposures to the telemetry
        `exp`; `params0` (the previous fit's) warm-starts the fit and adds the
        prior toward it. Returns (params, rms, inv_response, grad_weight,
        inv_vignette)."""
        n = obs.shape[1]
        if params0 is not None:
            params = params0._replace(log_exp=params0.log_exp.new_zeros(n))
        else:
            params = PC.init_params(n, device=obs.device)
        params, rms = PC.calibrate(params, obs, torch.arange(n, device=obs.device), r2, mask,
                                   exp_known=exp if known else None, prev=params0)
        lut = PC.gamma_lut(params)
        inv_vig = 1.0 / PC.vignette_map(params, self.height, self.width)
        return params, rms, invert_response(lut), response_grad_weight(lut), inv_vig

    def _pc_resync_state(self, images, imm_color, imm_u, imm_v, pts_color, pts_u, pts_v,
                         inv_resp, inv_vig):
        """Re-correct the photometric state the window holds when the first
        fit switches the correction on: the keyframe images with their
        gradients, and the pattern colours of candidates and points, all
        built from uncorrected frames (exact: the earlier correction was the
        identity)."""
        I = photometric_correct(images[..., 0], inv_resp, inv_vig)
        dx, dy = image_gradients(I)
        pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=images.device)

        def fix_colors(c, u, v):
            up = torch.clamp(u[:, None] + pat[None, :, 0], 0.0, self.width - 1.0)
            vp = torch.clamp(v[:, None] + pat[None, :, 1], 0.0, self.height - 1.0)
            return photometric_correct(c, inv_resp, None) * bilinear(inv_vig, up, vp)

        return (torch.stack([I, dx, dy], -1), fix_colors(imm_color, imm_u, imm_v),
                fix_colors(pts_color, pts_u, pts_v))

    def _pc_resync_template(self, tpl: trk_ops.Template, inv_resp, inv_vig):
        """The tracking template's colours re-corrected (the half of the
        first-fit resync that the tracking thread owns)."""
        colors = []
        for lvl, col in enumerate(tpl.color):
            f = float(1 << lvl)
            u0 = torch.clamp(tpl.u[lvl] * f, 0.0, self.width - 1.0)
            v0 = torch.clamp(tpl.v[lvl] * f, 0.0, self.height - 1.0)
            colors.append(photometric_correct(col, inv_resp, None) * bilinear(inv_vig, u0, v0))
        return tpl._replace(color=colors)

    def _photo_calib_step(self):
        """One online refit on the tracking thread: warp the template into
        the ring frames (relative poses and the known-exposure test from the
        shells, on the host), sample their raw intensities and fit on the
        device without a host sync. The first fit switches the correction on
        and re-corrects the template (and a staged one) here and the window
        on the mapping thread; later fits are blended into it. True if a fit
        landed."""
        if self.template is None:
            return False
        with self._shell_lock:
            ref_c2w = self.shells[self.ref_shell_id].cam_to_world.copy()
            rels = np.stack([np.linalg.inv(self.shells[sid].cam_to_world) @ ref_c2w
                             for sid, _ in self._pc_ring])
            exps = np.asarray([self.shells[sid].exposure or 1.0 for sid, _ in self._pc_ring],
                              np.float32)
        # all-ones exposures mean "unknown" (the dataset convention when no
        # exposure file exists); telemetry pins the fit's gauge
        known = bool(np.any(np.abs(exps - 1.0) > 1e-9))
        tpl = self.template
        obs, r2, mask = self._pc_sample(
            tpl.u[0], tpl.v[0], tpl.idepth[0], tpl.valid[0], self.calib.value[:4],
            self._f32(rels[:, :3, :3]), self._f32(rels[:, :3, 3]),
            torch.stack([r for _, r in self._pc_ring]))
        params, rms, inv_resp, grad_w, inv_vig = self._pc_fit(
            obs, r2, mask, self._f32(exps), known, self._pc_params)
        first = self._pc_luts is None
        self._pc_pend_fixed = -1
        if first:
            luts = (inv_resp, inv_vig, grad_w)
            self.template = self._pc_resync_template(self.template, inv_resp, inv_vig)
            # a template staged for publication was built uncorrected too
            with self._ref_lock:
                if self._pending_ref is not None:
                    tpl_, *rest = self._pending_ref
                    self._pending_ref = (self._pc_resync_template(tpl_, inv_resp, inv_vig),
                                         *rest)
                    self._pc_pend_fixed = rest[1]
        else:
            # later fits blend into the applied correction: an abrupt change
            # would de-sync new frames from every keyframe image in the window
            a = self._pc_blend
            luts = tuple((1 - a) * old + a * new for old, new in
                         zip(self._pc_luts, (inv_resp, inv_vig, grad_w)))
        self._pc_publish(params, rms, luts, first)
        return True

    def _pc_publish(self, params, rms, luts, first: bool):
        """A fit's state; the first one asks the mapping thread for the
        window's re-correction. A follower keeps each fit's correction until
        that re-correction has run (rank 0 names the fit it used)."""
        with self._pc_cond:
            self._pc_params, self._pc_rms, self._pc_luts = params, rms, luts
            self.n_photo_fits += 1
            if first:
                self._pc_window_resync = True
            if self._follower and self._pc_window_resync:
                self._pc_luts_hist[self.n_photo_fits] = luts
            self._pc_cond.notify_all()

    def _pc_apply_fit(self, tensors, pend: int):
        """A follower: the fit state rank 0 sent ([*params, rms, *luts]).
        A first fit re-corrects what rank 0's re-corrected: the held
        template, and the staged reference `pend` (here once it is
        published, if it is not yet)."""
        n = len(PC.PhotoParams._fields)
        luts = tuple(tensors[n + 1:])
        first = self._pc_luts is None
        if first:
            inv_resp, inv_vig, _ = luts
            if self.template is not None:
                self.template = self._pc_resync_template(self.template, inv_resp, inv_vig)
            with self._ref_cond:
                ref = self._pub_refs.get(pend)
                if ref is not None:
                    self._pub_refs[pend] = (self._pc_resync_template(ref[0], inv_resp, inv_vig),
                                            *ref[1:])
                elif pend >= 0:
                    self._pc_fix_ref = (pend, inv_resp, inv_vig)
        self._pc_publish(PC.PhotoParams(*tensors[:n]), tensors[n], luts, first)

    def _kf_inputs(self):
        """What a keyframe step reads of the tracking thread's state, as of
        now: the tracker's reference slot, the indirect-weight scale, and
        (fit number, correction) when the first fit's re-correction of the
        window is due (claimed here), else None."""
        # indirect-weight schedule: lean on the geometric terms (up to 3x)
        # when the photometric tracker runs worse than its own baseline
        if self.cfg.indirect_weight_schedule and self.first_coarse_rmse > 0:
            iw_scale = float(np.clip(
                self.last_coarse_rmse[0] / max(self.first_coarse_rmse, 1e-6), 1.0, 3.0))
        else:
            iw_scale = 1.0
        resync = None
        with self._pc_cond:
            if self._pc_window_resync:
                self._pc_window_resync = False
                resync = (self.n_photo_fits, self._pc_luts)
        return self.ref_slot, iw_scale, resync

    def _replayed_kf_inputs(self, dec: dict):
        """A follower: _kf_inputs as rank 0 read them for this step, the
        re-correction with the fit it named (waiting for this rank's
        tracking thread to have applied that fit)."""
        resync = None
        k = int(dec["resync_fit"])
        if k:
            with self._pc_cond:
                if not self._pc_cond.wait_for(lambda: k in self._pc_luts_hist,
                                              timeout=REPLAY_TIMEOUT_S):
                    raise TimeoutError(f"fit {k} never reached this rank")
                resync = (k, self._pc_luts_hist[k])
                self._pc_luts_hist.clear()
                self._pc_window_resync = False
        return int(dec["ref_slot"]), dec["iw_scale"], resync

    # ------------------------------------------------------ metrics stream
    def _emit_metrics(self, **fields):
        """One JSONL record on the metrics stream (no-op without metrics_path)."""
        if self._metrics_f is None:
            return
        line = json.dumps(fields) + "\n"
        with self._metrics_lock:
            if self._metrics_f is not None:
                self._metrics_f.write(line)
                self._metrics_f.flush()

    _MAP_MAX_PTS = 1024   # decimation cap per map record

    def _emit_map_record(self, b):
        """One "map" record per keyframe: the window's point cloud (world
        space, filtered, decimated to _MAP_MAX_PTS) and the window keyframes'
        poses, the live 3D view's feed (GUI::UploadKeyFrame,
        Include/Display.h:126-141). Every record carries the clouds of all
        window keyframes, so BA updates refresh what was drawn."""
        xyz, ok, inten = (x.cpu().numpy() for x in map_cloud(
            self.window.frames, self.window.points, self.calib.value))   # host sync
        idx = np.flatnonzero(ok)
        if len(idx) > self._MAP_MAX_PTS:
            idx = idx[:: len(idx) // self._MAP_MAX_PTS + 1]
        pts = np.concatenate([xyz[idx], np.clip(inten[idx], 0, 255)[:, None]], axis=1)
        kfs = [{"kf": int(b.kf_id[s]),
                "R": [round(float(x), 5) for x in np.asarray(b.Rwc[s]).ravel()],
                "t": [round(float(x), 5) for x in np.asarray(b.twc[s])]}
               for s in range(self.cfg.max_frames) if b.valid[s]]
        self._emit_metrics(t="map", kf_id=int(np.max(b.kf_id)),
                           pts=[[round(float(c), 4) for c in p] for p in pts], kfs=kfs)

    # ------------------------------------------------------ mapping thread
    def _mapping_loop(self):
        """Consumer of the tracked-frame queue, the reference's MappingThread
        policy (Mapping.cpp:143-214), one step at a time: decided here
        (_map_decide; rank 0 of a mesh sends each decision) or replayed
        from rank 0's decision (_map_replay, the other ranks), then run
        (_map_execute)."""
        while True:
            try:
                step = self._map_replay() if self._follower else self._map_decide()
            except Exception as e:    # the control stream broke: nothing more to replay
                self._map_exc = e
                with self._qcond:
                    self._map_busy = False
                    self._map_broken = True
                    self._qcond.notify_all()
                return
            if step is None:
                return
            try:
                self._map_execute(*step)
            except Exception as e:        # raised on the tracking thread
                self._map_exc = e
                with self._ref_cond:      # a follower waiting for a reference
                    self._ref_cond.notify_all()
            finally:
                with self._qcond:
                    self._map_busy = False
                    self._qcond.notify_all()

    def _map_decide(self):
        """The policy: the first two tracked frames after init are forced
        keyframes; while more frames wait, the popped one is traced as a
        non-keyframe (in catch-up the next one is dropped too; beyond
        CATCHUP_DRAIN waiting, all but the freshest are); the freshest frame
        becomes a keyframe iff the NeedNewKFAfter latch outlives the newest
        keyframe; the worker's newest correction folds in first. Returns the
        step (None once stopped and drained); on a mesh, sends it."""
        with self._qcond:
            while not self._queue and not self._map_stop:
                self._qcond.wait()
            popped = self._pop_step() if self._queue else None
        if popped is None:
            if self._map is not None:
                self._map.send(kind=M_END, sid=-1, n_drop=0, action=TRACE, extra=-1,
                               corr=-1, ref_slot=-1, iw_scale=1.0, resync_fit=0)
            return None
        shell, pyr, grads, dropped, extra, action = popped
        corr = self._newest_loop_corr()
        inputs = None if action == TRACE else self._kf_inputs()
        if self._map is not None:
            self._map.send(kind=M_STEP, sid=shell.id, n_drop=len(dropped), action=action,
                           extra=-1 if extra is None else extra.id, corr=corr,
                           ref_slot=-1 if inputs is None else inputs[0],
                           iw_scale=1.0 if inputs is None else inputs[1],
                           resync_fit=0 if inputs is None or inputs[2] is None else inputs[2][0])
        return shell, pyr, grads, dropped, extra, action, corr, inputs

    def _pop_step(self):
        """Under _qcond, with frames queued: pop this step's frames and pick
        its action (_map_decide's policy)."""
        shell, pyr, grads = self._queue.popleft()
        more = len(self._queue)
        self._map_busy = True
        dropped, extra = [], None
        if more > self.CATCHUP_DRAIN:
            # severe overload: keep only the freshest frame
            dropped.append(shell)
            while len(self._queue) > 1:
                dropped.append(self._queue.popleft()[0])
            shell, pyr, grads = self._queue.pop()
            more = 0
        if len(self.kf_shell_ids) <= 2:
            action = KF_FORCED          # the init gates are live: synchronous
        elif more > 0:
            if more > 3:
                self._catch_up = True
            action = TRACE
            if self._catch_up:
                # drop every second frame while behind (Mapping.cpp:177-192);
                # the tracking thread only appends, so this is the frame
                # that waited behind the popped one
                extra = self._queue.popleft()[0]
        elif self._need_kf_after >= (self.kf_shell_ids[-1] if self.kf_shell_ids else -1):
            action = KF_DEFER
            self._catch_up = False
        else:
            action = TRACE
        return shell, pyr, grads, dropped, extra, action

    def _map_replay(self):
        """A follower's step: rank 0's decision, with the frames it names
        popped from this rank's queue once its tracking thread has queued
        them. None at rank 0's end mark."""
        dec = self._map.recv()
        if dec["kind"] == M_END:
            return None
        n_drop, has_extra = int(dec["n_drop"]), dec["extra"] >= 0
        n_pop = n_drop + 1 + int(has_extra)
        with self._qcond:
            if not self._qcond.wait_for(lambda: len(self._queue) >= n_pop,
                                        timeout=REPLAY_TIMEOUT_S):
                raise TimeoutError(f"rank 0's step on frame {int(dec['sid'])} names frames "
                                   "this rank never queued")
            items = [self._queue.popleft() for _ in range(n_pop)]
            self._map_busy = True
        shell, pyr, grads = items[n_drop]
        extra = items[-1][0] if has_extra else None
        if shell.id != int(dec["sid"]) or (has_extra and extra.id != int(dec["extra"])):
            raise RuntimeError(f"rank 0 stepped on frame {int(dec['sid'])} where this rank's "
                               f"queue holds frame {shell.id}: the ranks' calls differ")
        action = int(dec["action"])
        inputs = None if action == TRACE else self._replayed_kf_inputs(dec)
        return (shell, pyr, grads, [it[0] for it in items[:n_drop]], extra, action,
                int(dec["corr"]), inputs)

    def _map_execute(self, shell, pyr, grads, dropped, extra, action, corr, inputs):
        """Run one mapping step as decided. A loop correction folds in only
        after a deferred keyframe finalization (the deferred bundle's poses
        predate the correction), and before the keyframe or trace step
        touches the window."""
        if corr >= 0:
            self._finalize_pending_kf()
            self._apply_loop_corr_number(corr)
        if dropped:
            self._rebase_shells(dropped)
            self.n_frames_skipped += len(dropped)
        if action == TRACE:
            self._process_non_kf(shell, pyr)
            self._finalize_pending_kf()
            if extra is not None:
                self._rebase_shells([extra])
                self.n_frames_skipped += 1
            return
        self._finalize_pending_kf()
        t_kf = _time.perf_counter()
        self._add_keyframe(shell, pyr, grads, defer=action == KF_DEFER, inputs=inputs)
        self.kf_latencies.append(_time.perf_counter() - t_kf)

    def _rebase_shells(self, shells):
        """Pose bookkeeping of frames the mapper drops."""
        with self._shell_lock:
            for sh in shells:
                if sh.tracking_ref is not None:
                    sh.cam_to_world = self.shells[sh.tracking_ref].cam_to_world @ sh.cam_to_ref

    def _wait_mapping_idle(self):
        """Until the mapping queue is empty and no step runs (or the mapping
        thread ended on a broken control stream)."""
        with self._qcond:
            while (self._queue or self._map_busy) and not self._map_broken:
                self._qcond.wait()

    def finish(self, wait_lc: bool = True):
        """BlockUntilMappingIsFinished: drain the mapping queue and fold in a
        deferred keyframe finalization; with `wait_lc` also drain the
        loop-closure worker and apply the newest correction it left (the
        mapping thread is idle at this barrier, so applying here cannot race
        a keyframe step; every rank of a mesh has the same corrections
        here). `wait_lc=False` leaves the worker running: loop closure is a
        background service, and a throughput measurement need not block on
        it. No-op in sequential mode."""
        if self.sequential:
            return
        if self._follower:
            self._recv_frame(R_FINISH)
        else:
            self._send_frame(R_FINISH)
        self._wait_mapping_idle()
        if self._map_exc is None:
            self._finalize_pending_kf()
        if wait_lc and self._lc_thread is not None:
            with self._lc_cond:
                while self._lc_queue or self._lc_busy:
                    self._lc_cond.wait()
            if self._map_exc is None:
                self._apply_pending_loop_corr()
        self._raise_thread_excs()

    def _raise_thread_excs(self):
        """Raise what the mapping thread or the loop-closure worker left;
        if both failed, the worker's exception is chained as the context."""
        if self._map_exc is not None:
            exc, self._map_exc = self._map_exc, None
            if self._lc_exc is not None:
                exc.__context__, self._lc_exc = self._lc_exc, None
            raise exc
        if self._lc_exc is not None:
            exc, self._lc_exc = self._lc_exc, None
            raise exc

    def close(self):
        """Stop and join the mapping thread and the loop-closure worker
        (after finish()), then flush and close the metrics stream. Raises an
        exception of either thread that was not raised yet. On a mesh, rank
        0 first sends its end mark, which a follower still waiting for a
        record raises on, and which every follower's close takes."""
        try:
            if self._trk is not None and not self._trk_ended:
                if self._follower:
                    self._end_of_stream()
                else:
                    self._send_frame(R_END)
        finally:
            self._stop_threads()
        self._raise_thread_excs()

    def _end_of_stream(self):
        """A follower's close: rank 0's records up to its end mark (records
        this rank did not replay, after a failure here, are passed over)."""
        while True:
            rec = self._trk.recv()
            if rec["kind"] == R_END:
                self._trk_ended = True
                return
            if rec["fit"]:
                self._trk.recv_tensors("cpu")

    def _stop_threads(self):
        try:
            if self._map_thread is not None:
                with self._qcond:
                    self._map_stop = True
                    self._qcond.notify_all()
                self._join(self._map_thread, "mapping thread")
                self._map_thread = None
            if self._lc_thread is not None:
                with self._lc_cond:
                    self._lc_stop = True
                    self._lc_cond.notify_all()
                self._join(self._lc_thread, "loop-closure worker")
                self._lc_thread = None
        finally:
            with self._metrics_lock:
                if self._metrics_f is not None:
                    self._metrics_f.close()
                    self._metrics_f = None

    @staticmethod
    def _join(thread, what):
        thread.join(timeout=60.0)
        if thread.is_alive():
            raise RuntimeError(f"{what} did not stop within 60 s")

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
    def _add_keyframe(self, shell: Shell, pyr, grads, defer: bool = False, inputs=None):
        """AddKeyframe: host policy on the mirrors, the keyframe step, the
        tracker reference published at once, then the bundle-dependent
        finalization (left pending when `defer`, after the init gates).
        `inputs`: _kf_inputs() as the mapping thread's step read them (None:
        read now)."""
        cfg = self.cfg
        F = cfg.max_frames
        t0 = _time.perf_counter()
        ref_slot, iw_scale, resync = self._kf_inputs() if inputs is None else inputs
        shell.is_kf = True
        shell.kf_id = self.next_kf_id
        self.next_kf_id += 1
        if shell.tracking_ref is not None:
            with self._shell_lock:
                shell.cam_to_world = self.shells[shell.tracking_ref].cam_to_world @ shell.cam_to_ref
        if resync is not None:
            # the first photometric fit landed since the last keyframe: this
            # thread owns the window here
            inv_resp, inv_vig, _ = resync[1]
            pts, imm = self.window.points, self.imm
            images, imm_c, pts_c = self._pc_resync_state(
                self.window.frames.images, imm.color, imm.u, imm.v, pts.color, pts.u, pts.v,
                inv_resp, inv_vig)
            self.window = self.window._replace(
                frames=self.window.frames._replace(images=images),
                points=pts._replace(color=pts_c))
            self.imm = imm._replace(color=imm_c)
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
        Twc = np.linalg.inv(shell.cam_to_world)
        window, calib, imm, feats, template, _result, bundle = KS.kf_step(
            self.window, self.calib, self.imm, self.feats, pyr, self._f32(Twc[:3, :3]),
            self._f32(Twc[:3, 3]), self._f32(shell.aff), self._f32(shell.exposure or 1.0),
            slot, shell.kf_id, ref_slot, flag_mask, float(self.current_min_act_dist),
            iters, sel_u, sel_v, sel_type, sel_valid, cfg, ind_w_scale=iw_scale,
            mesh=self.dist_mesh)
        self.window, self.calib, self.imm, self.feats = window, calib, imm, feats
        self._K_pyr_cache = k_pyr_from_value(self.calib.value, cfg.pyr_levels)
        self.slot_shell[slot] = shell.id
        self.kf_shell_ids.append(shell.id)
        # publish the tracker reference now (the coarseTracker_forNewKF
        # double buffer); the BA-refined affine follows in _finalize_kf
        self._newest_template = template
        ref = (template, slot, shell.id, np.asarray(shell.aff, np.float64).copy(),
               shell.exposure or 1.0)
        if self.sequential:
            (self.template, self.ref_slot, self.ref_shell_id,
             self.ref_aff, self.ref_exposure) = ref
            self.first_coarse_rmse = -1.0
        elif self._follower:
            with self._ref_cond:
                fix = self._pc_fix_ref
                if fix is not None and fix[0] == shell.id:
                    ref = (self._pc_resync_template(template, *fix[1:]), *ref[1:])
                    self._pc_fix_ref = None
                self._pub_refs[shell.id] = ref
                self._ref_cond.notify_all()
        else:
            with self._ref_lock:
                self._pending_ref = ref
        pending = (shell, slot, flag_mask, bundle, pyr, t0)
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
        connectivity, selector density adaptation, the reference's
        BA-refined affine, the loop-closure hand-off."""
        cfg = self.cfg
        F = cfg.max_frames
        shell, slot, flag_mask, bundle, pyr, t0 = pending
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
        latency = _time.perf_counter() - t0
        self.kf_full_latencies.append(latency)
        self._emit_metrics(
            t="kf", id=shell.id, kf_id=shell.kf_id, ba_rmse=rmse, n_active=int(b.n_active),
            n_ind=int(b.n_ind), n_marg_frames=int(flag_mask.sum()),
            latency_ms=round(1e3 * latency, 2))
        if self._metrics_f is not None:
            self._emit_map_record(b)
        for s in range(F):
            if flag_mask[s]:
                self.slot_shell[s] = None
                self._marg_counts[s] = 0
            elif int(b.removed_host[s]):
                self._marg_counts[s] = self._marg_counts.get(s, 0) + int(b.removed_host[s])
        # connectivity map from the device tallies of this keyframe step
        for h_, t_ in zip(*np.nonzero((b.conn_active > 0) | (b.conn_marg > 0))):
            if h_ == t_:
                continue
            link = self.connectivity.setdefault((int(b.kf_id[h_]), int(b.kf_id[t_])), [0, 0])
            if b.conn_active[h_, t_] > 0:
                link[0] = int(b.conn_active[h_, t_])
            link[1] += int(b.conn_marg[h_, t_])
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
            pub = self._pub_refs.get(shell.id)     # a follower's publication
            if pub is not None:
                self._pub_refs[shell.id] = (*pub[:3], aff_ba, pub[4])
        if self.enable_loop_closure:
            self._loop_closure_step(slot, shell, pyr, b)

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

    # -------------------------------------------------------- loop closure
    def _make_loop_closer(self, vocab: bow_ops.Vocabulary) -> LoopCloser:
        return LoopCloser(vocab, min_gap=10, dist_mesh=self._edge_mesh,
                          min_loop_error_rel=1.0, consistency_th=2)

    def _lift_keypoint_depths(self, u, v, radius_px: float = 3.0):
        """Nearest-template-point inverse depth of keypoints, from the newest
        template (the one just built for the current keyframe), else the
        tracking reference's. Returns (idepth (N,), depth_ok (N,))."""
        tpl = self._newest_template or self.template
        if tpl is None:
            return torch.zeros_like(u), torch.zeros_like(u, dtype=torch.bool)
        tid, dmin = trk_ops.nearest_template_depth(u, v, tpl.u[0], tpl.v[0],
                                                   tpl.idepth[0], tpl.valid[0])
        return tid, dmin <= radius_px * radius_px

    def _loop_closure_step(self, slot: int, shell: Shell, pyr, bundle):
        """Per-keyframe loop-closure hook: gather descriptors and keypoint
        depths, then run BoW, PnP and the pose graph inline (sequential) or
        hand them to the loop-closure worker, off the mapping thread's
        per-keyframe latency."""
        if self.cfg.enable_indirect:
            # the keyframe's stored multi-scale features (extracted once in
            # kf_step), with the inverse depths lifted inside that step and
            # pulled with the policy bundle
            feats = self.feats
            u, v = feats.u[slot], feats.v[slot]
            valid, desc = feats.valid[slot], feats.desc[slot]
            kp_idepth, kp_depth_ok = bundle.kp_idepth, bundle.kp_depth_ok
        else:
            u, v, valid, desc = self._orb_features(pyr[0][..., 0])
            kp_idepth, kp_depth_ok = self._lift_keypoint_depths(u, v)
        entry = (shell.kf_id, shell.id, desc, u, v, valid, shell.cam_to_world.copy(),
                 kp_idepth, kp_depth_ok)
        exclude = self._connected_kf_ids(shell.kf_id)
        # the intrinsics as this keyframe step left them: the worker must not
        # read the calibration a later step is rewriting
        fx, fy, cx, cy = self.calib.value.cpu().numpy().astype(np.float64)
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        if self._lc_thread is None:
            corr = self._lc_process(entry, exclude, K)
            if corr is not None:
                self._apply_loop_correction(corr)
        else:
            with self._lc_cond:
                self._lc_queue.append((entry, exclude, K))
                self._lc_cond.notify_all()

    def _lc_process(self, entry, exclude_kfs, K):
        """Vocabulary bootstrap, BoW detection and pose-graph correction for
        one keyframe entry (K: the 3x3 intrinsics). Returns the correction
        {shell_id: cam_to_world} or None. Runs on the caller's or the
        mapping thread (sequential) or on the loop-closure worker."""
        if self.loop_closer is None:
            desc, valid = (x.cpu().numpy() for x in (entry[2], entry[5]))
            self._vocab_descs.append(desc[valid])
            self._pending_entries.append(entry)
            if len(self._vocab_descs) >= 8:
                doc_ids = np.concatenate([np.full(len(d), i, np.int32)
                                          for i, d in enumerate(self._vocab_descs)])
                voc = bow_ops.train_vocabulary(
                    np.concatenate(self._vocab_descs), k=8, levels=3, iters=4,
                    doc_ids=doc_ids, device=self.device)
                closer = self._make_loop_closer(voc)
                # backfill the keyframes that fed the vocabulary: without
                # them the revisit has nothing to match against
                for e in self._pending_entries:
                    closer.add_keyframe(*e[:7], kp_idepth=e[7], kp_depth_ok=e[8])
                self.loop_closer = closer
                self._vocab_descs, self._pending_entries = [], []
            return None

        closer = self.loop_closer
        closer.add_keyframe(*entry[:7], kp_idepth=entry[7], kp_depth_ok=entry[8])
        t_lc = _time.perf_counter()
        loop = closer.detect(len(closer.entries) - 1, K, exclude_kfs=exclude_kfs)
        self.lc_detect_ms.append(1e3 * (_time.perf_counter() - t_lc))
        if loop is None:
            return None
        corrections = closer.correct(loop, fix_scale=False)
        if not corrections:
            return None    # relaxation rejected (divergence gate)
        self.n_loops_closed += 1
        return dict(corrections)

    def _lc_loop(self):
        """Loop-closure worker: consumes keyframe entries, computes
        corrections and leaves them, numbered in order, in _lc_corrs for
        the mapping thread to apply between keyframe steps; replacing the
        window must never race a kf_step. It reads nothing but its entries
        (made by the mapping thread, which runs in lockstep on a mesh), so
        every rank's worker makes the same corrections."""
        while True:
            with self._lc_cond:
                while not self._lc_queue and not self._lc_stop:
                    self._lc_cond.wait()
                if self._lc_stop and not self._lc_queue:
                    return
                item = self._lc_queue.popleft()
                self._lc_busy = True
            try:
                corr = self._lc_process(*item)
                if corr is not None:
                    with self._lc_corr_cond:
                        self._lc_n_corrs += 1
                        self._lc_corrs[self._lc_n_corrs] = corr
                        self._lc_corr_cond.notify_all()
            except Exception as e:        # raised by finish or close
                self._lc_exc = e
                with self._lc_corr_cond:
                    self._lc_corr_cond.notify_all()
            finally:
                with self._lc_cond:
                    self._lc_busy = False
                    self._lc_cond.notify_all()

    def _newest_loop_corr(self) -> int:
        """The number of the newest correction not yet applied, else -1."""
        with self._lc_corr_cond:
            return max(self._lc_corrs, default=-1)

    def _apply_loop_corr_number(self, k: int):
        """On the mapping thread: fold in the worker's k-th correction
        (waiting for it on a follower) and forget the older unapplied ones:
        the k-th relaxation already includes their effect (correct() updated
        the entry poses)."""
        with self._lc_corr_cond:
            if not self._lc_corr_cond.wait_for(
                    lambda: k in self._lc_corrs or self._lc_exc is not None,
                    timeout=REPLAY_TIMEOUT_S):
                raise TimeoutError(f"loop correction {k} never came from this rank's worker")
            if k not in self._lc_corrs:
                raise RuntimeError(f"the loop-closure worker failed before correction {k}")
            corr = self._lc_corrs.pop(k)
            for j in [j for j in self._lc_corrs if j < k]:
                del self._lc_corrs[j]
        self._apply_loop_correction(corr)

    def _apply_pending_loop_corr(self):
        """At the finish barrier (mapping thread and worker idle): fold in
        the newest correction the worker left, if any."""
        k = self._newest_loop_corr()
        if k >= 0:
            self._apply_loop_corr_number(k)

    def _apply_loop_correction(self, by_shell: dict):
        """Re-anchor trajectory and window after a pose-graph correction.

        The active window gets ONE common gauge transform G, the newest
        window keyframe's correction, applied to every window frame:
        c2w' = G @ c2w, i.e. worldToCam' = worldToCam @ G^-1. A common
        right-composition leaves every relative pose (and the idepths)
        untouched, so the photometric residuals and the marginalization
        prior HM/bM stay exactly consistent; the absolute shift lives in
        the gauge nullspace the solver orthogonalizes anyway. (Per-keyframe
        corrections inside the window would move the evalPTs relative to
        each other and silently invalidate HM/bM.)"""
        frames = self.window.frames
        valid_np = frames.valid.cpu().numpy()                    # host sync
        win_sids = {self.slot_shell[s] for s in range(self.cfg.max_frames)
                    if valid_np[s] and self.slot_shell[s] is not None}
        anchor_sid = next((sid for sid in sorted(win_sids, reverse=True)
                           if sid in by_shell), None)
        with self._shell_lock:
            if anchor_sid is not None:
                G = by_shell[anchor_sid] @ np.linalg.inv(self.shells[anchor_sid].cam_to_world)
            else:
                G = np.eye(4)
            corrected = set()
            for sh in self.shells:
                if sh.id in win_sids:
                    sh.cam_to_world = G @ sh.cam_to_world
                    corrected.add(sh.id)
                elif sh.id in by_shell:
                    sh.cam_to_world = by_shell[sh.id]
                    corrected.add(sh.id)
            # non-keyframe shells ride their tracking reference through the
            # correction (cam_to_world = ref_c2w @ cam_to_ref)
            for sh in self.shells:
                if sh.id not in corrected and sh.tracking_ref in corrected:
                    sh.cam_to_world = self.shells[sh.tracking_ref].cam_to_world @ sh.cam_to_ref
        # evalPT' = evalPT @ G^-1 over the valid slots; the per-frame state
        # deltas are relative to evalPT and stay valid. A new Frames is
        # built and the window swapped: nothing is written in place.
        G_inv = np.linalg.inv(G)
        Rg, tg = self._f32(G_inv[:3, :3]), self._f32(G_inv[:3, 3])
        m = frames.valid[:, None, None]
        frames = frames._replace(
            evalpt_R=torch.where(m, frames.evalpt_R @ Rg, frames.evalpt_R),
            evalpt_t=torch.where(m[:, :, 0], frames.evalpt_R @ tg + frames.evalpt_t,
                                 frames.evalpt_t))
        self.window = self.window._replace(frames=frames)

    def _connected_kf_ids(self, kf_id: int) -> set:
        """Keyframes sharing residuals (active or marginalized) with kf_id."""
        out = set()
        for (h, t), (na, nm) in self.connectivity.items():
            if na + nm <= 0:
                continue
            if h == kf_id:
                out.add(t)
            elif t == kf_id:
                out.add(h)
        return out

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
        self.connectivity = {}
        self.initialized = False
        self.init_failed = False
        self._init_first = None
        self.slot_shell = [None] * cfg.max_frames
        self.next_kf_id = 0
        self.template = None
        self._newest_template = None
        with self._ref_lock:
            self._pending_ref = None
        self.ref_slot = -1
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = np.full(5, 100.0)

    def trajectory(self):
        """All frame poses (camToWorld) for export."""
        return [(s.timestamp, s.cam_to_world[:3, :3], s.cam_to_world[:3, 3])
                for s in self.shells]
