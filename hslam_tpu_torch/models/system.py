"""The per-frame SLAM pipeline, sequential direct-only slice (port of
hslam_tpu/models/system.py).

`SLAMSystem.process_frame` is the entry: pyramid (CUDA kernel on a CUDA
device), then either the bootstrap (selector -> KLT -> two-view -> KF0
seeding) or tracking against the reference keyframe's template, the
keyframe decision, and the keyframe step or non-keyframe tracing. The host
keeps the small state machine (shells, window slot bookkeeping, policy
mirrors refreshed from each keyframe's bundle), exactly as in the JAX
package; numeric work is torch on `device`.

Not in this slice, and refused with NotImplementedError instead of being
silently skipped: the indirect layer (`enable_indirect`, `use_fast`), the
photometric init refinement (`init_direct_refine`), loop closure, online
photometric calibration, the threaded mapping pipeline (`sequential=False`)
and point-sharded BA (`dist_mesh`). Relocalization needs features and PnP:
`_attempt_relocalization` returns None and counts `n_reloc_unported`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..models import kf_step as KS
from ..models import window as W
from ..models.calib import k_pyr_from_value, make_calib
from ..ops import klt as klt_ops
from ..ops import selector as sel_ops
from ..ops import tracker as trk_ops
from ..ops import twoview as tv_ops
from ..ops.pyramid import build_direct_pyramid
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
    relocalized: bool = False


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
    axes = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0), (0, -1, 0), (0, 0, -1),
            (1, 1, 0), (0, 1, 1), (1, 0, 1), (-1, 1, 0), (0, -1, 1), (-1, 0, 1),
            (1, -1, 0), (0, 1, -1), (1, 0, -1), (-1, -1, 0), (0, -1, -1), (-1, 0, -1),
            (-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1), (1, -1, -1), (1, -1, 1),
            (1, 1, -1), (1, 1, 1)]
    out = []
    for ax in axes:
        q = np.array([1.0, *(rot * np.asarray(ax, np.float64))])
        q /= np.linalg.norm(q)
        pert = np.eye(4)
        pert[:3, :3] = lie.quat_to_rot(
            torch.tensor([q[1], q[2], q[3], q[0]], dtype=torch.float32)).numpy()
        out.append(pert)
    return out


def init_seed(wnd: W.Window, img0, u, v, cand_ok, idepth, exposure: float,
              cfg: Config):
    """InitFromInitializer's numeric core (System.cpp:249-319): KF0 into
    slot 0 plus depth-prior'd active points. Returns (window, n_points)."""
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
    pts = wnd.points
    slots, write = assign_free_slots(pts.status == W.PT_EMPTY, cand_ok)

    def put(arr, vals):
        return scatter_update(arr, slots, write, vals)

    pts = pts._replace(
        kp_idx=put(pts.kp_idx, torch.full_like(slots, -1)),
        status=put(pts.status, torch.full_like(slots, W.PT_ACTIVE)),
        host=put(pts.host, torch.zeros_like(slots)),
        u=put(pts.u, u), v=put(pts.v, v), idepth=put(pts.idepth, idepth),
        idepth_zero=put(pts.idepth_zero, idepth), color=put(pts.color, col),
        weight=put(pts.weight, wgt),
        prior=put(pts.prior, torch.full_like(u, cfg.idepth_fix_prior)),
    )
    return W.Window(frames=W.Frames(**fr), points=pts, HM=wnd.HM, bM=wnd.bM), cand_ok.sum()


class SLAMSystem:
    """Monocular direct SLAM engine on torch (sequential, direct-only)."""

    MAX_HYP = 32
    _POT_LADDER = (3, 4, 5, 6, 8)

    def __init__(self, fx, fy, cx, cy, width, height, cfg: Config = Config(),
                 enable_loop_closure: bool = True, sequential: bool = True,
                 online_photo_calib: bool = False, dist_mesh=None,
                 device: str | torch.device = "cpu"):
        unported = {
            "cfg.enable_indirect=True": cfg.enable_indirect,
            "cfg.init_direct_refine=True": cfg.init_direct_refine,
            "cfg.use_fast=True": cfg.use_fast,
            "enable_loop_closure=True": enable_loop_closure,
            "online_photo_calib=True": online_photo_calib,
            "sequential=False": not sequential,
            "dist_mesh": dist_mesh is not None,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                "not ported to hslam_tpu_torch yet: " + ", ".join(bad))
        self.cfg = cfg
        self.device = torch.device(device)
        self.calib = make_calib(fx, fy, cx, cy, width, height, device=self.device)
        self.width, self.height = width, height
        self.n_reloc_unported = 0   # relocalization was needed (not ported)
        self.window = W.empty_window(cfg, height, width, device=self.device)
        self.imm = KS.empty_imm(cfg, device=self.device)
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
        self.template: Optional[trk_ops.Template] = None
        self.ref_slot = -1
        self.ref_shell_id = -1
        self.ref_aff = np.zeros(2)
        self.ref_exposure = 1.0
        self._init_first = None
        self._perts = _rot_perturbations()
        self._K_pyr_cache = k_pyr_from_value(self.calib.value, cfg.pyr_levels)

    # ------------------------------------------------------------ helpers
    def _f32(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _select_px(self, pot, dir_img, grads, want, seed):
        cfg = self.cfg
        status = sel_ops.select_pixels(dir_img, tuple(grads[:3]), pot, 1.0, seed, cfg)
        return sel_ops.compact_selection(status, grads[0], cfg.max_features, want, seed)

    # ------------------------------------------------------------ main entry
    def process_frame(self, image: np.ndarray, timestamp: float,
                      exposure: float = 1.0) -> Shell:
        """ProcessNewFrame (System.cpp:104-247). `image`: (H, W) grayscale,
        uint8 or float, geometrically and photometrically corrected."""
        raw = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
        pyr, grads = build_direct_pyramid(raw, self.cfg.pyr_levels)
        shell = Shell(id=self.frame_count, timestamp=timestamp, exposure=exposure,
                      cam_to_world=np.eye(4), tracking_ref=None,
                      cam_to_ref=np.eye(4), aff=np.zeros(2))
        self.frame_count += 1
        self.shells.append(shell)
        if not self.initialized:
            self._try_initialize(shell, pyr, grads)
            return shell
        if not self._track_new_coarse(shell, pyr):
            self.is_lost = True
            return shell
        if self._need_keyframe(shell):
            self._add_keyframe(shell, pyr, grads)
        else:
            self._process_non_kf(shell, pyr)
        return shell

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
        self.window, n_pts0_d = init_seed(
            self.window, first["dir0"], first["u"], first["v"],
            torch.as_tensor(ok_mask, device=self.device), self._f32(idepth),
            float(first_shell.exposure or 1.0), cfg)
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
        """Hypothesis list (System.cpp:347-405) + initial affine guess."""
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
        # one pull of the whole result per frame (host sync)
        flat = torch.cat([res.R.reshape(-1), res.t, res.aff, res.ok.float()[None],
                          res.residuals, res.flow]).cpu().numpy().astype(np.float64)
        R_h, t_h, aff_h = flat[:9].reshape(3, 3), flat[9:12], flat[12:14]
        ok_h = flat[14] > 0.5
        L = self.cfg.pyr_levels
        res_h, flow_h = flat[15:15 + L], flat[15 + L:18 + L]
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
        (System.cpp:428-481)."""
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
            self._attempt_relocalization(shell, pyr)
            shell.pose_valid = False
            T = tries[0]
            shell.cam_to_ref = np.linalg.inv(T)
            shell.tracking_ref = self.ref_shell_id
            shell.cam_to_world = self.shells[self.ref_shell_id].cam_to_world @ shell.cam_to_ref
            shell.aff = aff_init
            self._last_flow = np.zeros(3)
            return True

        self.last_coarse_rmse = np.where(np.isnan(achieved), 100.0, np.minimum(achieved, 1e9))
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = float(achieved[0])
        t_b = best.t.cpu().numpy().astype(np.float64)
        shell.cam_to_ref = np.linalg.inv(_se3_np(best.R.cpu().numpy(), t_b))
        shell.tracking_ref = self.ref_shell_id
        shell.cam_to_world = self.shells[self.ref_shell_id].cam_to_world @ shell.cam_to_ref
        shell.aff = best.aff.cpu().numpy().astype(np.float64)
        self._last_flow = best.flow.cpu().numpy().astype(np.float64)
        return bool(np.all(np.isfinite(t_b)))

    def _attempt_relocalization(self, shell: Shell, pyr):
        """BoW + PnP relocalization needs the indirect layer, which is not
        ported yet: count the attempt and report no pose."""
        self.n_reloc_unported += 1
        return None

    def _need_keyframe(self, shell: Shell) -> bool:
        cfg = self.cfg
        if shell.relocalized:
            return True
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
        if shell.tracking_ref is not None:
            shell.cam_to_world = self.shells[shell.tracking_ref].cam_to_world @ shell.cam_to_ref
        Tw = np.linalg.inv(shell.cam_to_world)
        tr = KS.trace_candidates(
            self.imm, self.window.frames, self.calib.value, self._f32(Tw[:3, :3]),
            self._f32(Tw[:3, 3]), self._f32(shell.aff),
            self._f32(shell.exposure or 1.0), pyr[0], self.cfg)
        self.imm = self.imm._replace(trace=tr)

    # ------------------------------------------------------------- keyframe
    def _add_keyframe(self, shell: Shell, pyr, grads):
        """AddKeyframe: host policy on the mirrors, the keyframe step, then
        the bundle-dependent finalization."""
        cfg = self.cfg
        F = cfg.max_frames
        shell.is_kf = True
        shell.kf_id = self.next_kf_id
        self.next_kf_id += 1
        if shell.tracking_ref is not None:
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
        Twc = np.linalg.inv(shell.cam_to_world)
        window, calib, imm, template, _result, bundle = KS.kf_step(
            self.window, self.calib, self.imm, pyr, self._f32(Twc[:3, :3]),
            self._f32(Twc[:3, 3]), self._f32(shell.aff), self._f32(shell.exposure or 1.0),
            slot, shell.kf_id, self.ref_slot, flag_mask, float(self.current_min_act_dist),
            iters, sel_u, sel_v, sel_type, sel_valid, cfg)
        self.window, self.calib, self.imm = window, calib, imm
        self._K_pyr_cache = k_pyr_from_value(self.calib.value, cfg.pyr_levels)
        self.slot_shell[slot] = shell.id
        self.kf_shell_ids.append(shell.id)
        self.template, self.ref_slot, self.ref_shell_id = template, slot, shell.id
        self.ref_aff = np.asarray(shell.aff, np.float64).copy()
        self.ref_exposure = shell.exposure or 1.0
        self.first_coarse_rmse = -1.0
        self._finalize_kf(shell, slot, flag_mask, bundle)

    def _finalize_kf(self, shell: Shell, slot: int, flag_mask, bundle):
        """The policy pull: init/lost gates, shell poses, policy mirrors,
        connectivity, selector density adaptation."""
        cfg = self.cfg
        F = cfg.max_frames
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
        for s in range(F):
            if flag_mask[s]:
                self.slot_shell[s] = None
                self._marg_counts[s] = 0
            elif int(b.removed_host[s]):
                self._marg_counts[s] = self._marg_counts.get(s, 0) + int(b.removed_host[s])
        have = max(int(b.sel_count), 1)
        ideal = self.selector_pot * np.sqrt(have / cfg.desired_immature_density)
        self.selector_pot = min(self._POT_LADDER, key=lambda p: abs(p - ideal))
        if self.ref_shell_id == shell.id:
            self.ref_aff = np.asarray(b.aff[slot], np.float64).copy()

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
        self.ref_slot = -1
        self.first_coarse_rmse = -1.0
        self.last_coarse_rmse = np.full(5, 100.0)

    def trajectory(self):
        """All frame poses (camToWorld) for export."""
        return [(s.timestamp, s.cam_to_world[:3, :3], s.cam_to_world[:3, 3])
                for s in self.shells]
