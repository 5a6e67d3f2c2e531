"""The keyframe step (port of hslam_tpu/models/kf_step.py:
trace_candidates, activate_candidates, flag_and_marg_points,
insert_new_traces, indirect_associate, kf_step).

AddKeyframe as one function: trace candidates into the new keyframe, the
indirect frontend (multi-scale keypoints and descriptors of the new
keyframe), insert it, activate candidates, indirect association (matched
keypoints become reprojection observations of keypoint-hosted points), the
windowed BA, outlier removal, the tracker template on the new reference,
the keypoint depth lift, point marginalization, new candidate traces
(keypoint-hosted ones first, then the selector picks), frame
marginalization, and the policy bundle the host state machine reads.

`flag_mask` is a host (numpy) array, so the per-slot `lax.cond` of the
JAX code (kf_step.py:632) is a plain `if`.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import FRAME_STATE_SCALE, PATTERN, Config
from ..models import window as W
from ..models.calib import Calib, level_intrinsics
from ..models.optimizer import BAResult, ba_optimize, marginalize_frame, marginalize_points
from ..ops import activation as act_ops
from ..ops import distmap as dist_ops
from ..ops import epipolar as epi_ops
from ..ops import features as ft
from ..ops import tracker as trk_ops
from ..parallel.dist_ba import sharded_ba_optimize, sharded_marginalize_points
from ..utils import lie, trace
from ..utils.compaction import assign_free_slots, scatter_update
from ..utils.interp import bilinear


class Imm(NamedTuple):
    """Candidate (immature) points, capacity cfg.max_immature."""

    valid: torch.Tensor        # (N,) bool
    host: torch.Tensor         # (N,) int32
    u: torch.Tensor
    v: torch.Tensor
    color: torch.Tensor        # (N, 8)
    weight: torch.Tensor       # (N, 8)
    gradH: torch.Tensor        # (N, 2, 2)
    my_type: torch.Tensor      # (N,)
    energy_th: torch.Tensor
    kp_idx: torch.Tensor       # (N,) int32 host keyframe keypoint, -1 for
                               # gradient-selected candidates
    trace: epi_ops.TraceState


def empty_imm(cfg: Config, device="cuda") -> Imm:
    n = cfg.max_immature
    f32 = dict(dtype=torch.float32, device=device)
    return Imm(
        valid=torch.zeros(n, dtype=torch.bool, device=device),
        host=torch.zeros(n, dtype=torch.int32, device=device),
        u=torch.zeros(n, **f32), v=torch.zeros(n, **f32),
        color=torch.zeros((n, 8), **f32), weight=torch.ones((n, 8), **f32),
        gradH=torch.zeros((n, 2, 2), **f32), my_type=torch.ones(n, **f32),
        energy_th=torch.zeros(n, **f32),
        kp_idx=torch.full((n,), -1, dtype=torch.int32, device=device),
        trace=epi_ops.init_trace_state(n, device),
    )


class KFBundle(NamedTuple):
    rmse: torch.Tensor
    valid: torch.Tensor
    kf_id: torch.Tensor
    Rwc: torch.Tensor
    twc: torch.Tensor
    aff: torch.Tensor
    exposure: torch.Tensor
    calib_value: torch.Tensor
    n_active: torch.Tensor
    n_active_host: torch.Tensor
    n_imm_host: torch.Tensor
    sel_count: torch.Tensor
    removed_host: torch.Tensor
    conn_active: torch.Tensor
    conn_marg: torch.Tensor
    flow_ok: torch.Tensor
    n_ind: torch.Tensor
    kp_idepth: torch.Tensor
    kp_depth_ok: torch.Tensor


def _hslot(host, F):
    return torch.clamp(host.long(), 0, F - 1)


def trace_candidates(imm: Imm, frames: W.Frames, calib_value, R_new, t_new,
                     aff_new, exp_new, target, cfg: Config) -> epi_ops.TraceState:
    """traceNewCoarse: epipolar-trace every candidate into the new frame."""
    F = frames.valid.shape[0]
    R_f, t_f = W.frame_poses(frames)
    Ri, ti = lie.se3_inverse(R_f, t_f)
    R_rel = R_new[None] @ Ri
    t_rel = (R_new @ ti[..., None])[..., 0] + t_new[None]
    fx, fy, cx, cy = calib_value[0], calib_value[1], calib_value[2], calib_value[3]
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]),
                     torch.stack([z, z, o])])
    Kinv = torch.stack([torch.stack([1.0 / fx, z, -cx / fx]),
                        torch.stack([z, 1.0 / fy, -cy / fy]), torch.stack([z, z, o])])
    KRKi = K @ R_rel @ Kinv
    Kt = (K @ t_rel[..., None])[..., 0]
    aff_f = W.frame_affine(frames)
    exp_f = torch.where(frames.exposure == 0, torch.ones_like(frames.exposure), frames.exposure)
    exp_n = torch.where(exp_new == 0, torch.ones_like(exp_new), exp_new)
    a_rel = torch.exp(aff_new[0] - aff_f[:, 0]) * exp_n / exp_f
    b_rel = aff_new[1] - a_rel * aff_f[:, 1]
    h = _hslot(imm.host, F)
    return epi_ops.trace_on(
        imm.trace, imm.u, imm.v, imm.color, imm.weight, imm.gradH,
        imm.energy_th, imm.valid, KRKi[h], Kt[h],
        torch.stack([a_rel[h], b_rel[h]], -1), target, cfg=cfg)


def activate_candidates(window: W.Window, calib: Calib, imm: Imm, new_slot: int,
                        act_dist: float, cfg: Config) -> Tuple[W.Window, Imm]:
    """activatePointsMT: candidate deletion, distance-map spread gating,
    batched idepth GN, insertion of the activated points."""
    frames, pts = window.frames, window.points
    tr = imm.trace
    F = frames.valid.shape[0]
    H0, W0 = frames.images.shape[1], frames.images.shape[2]
    h2, w2 = H0 // 2, W0 // 2
    S = epi_ops

    valid = imm.valid & ~(~torch.isfinite(tr.idepth_max) | (tr.status == S.IPS_OUTLIER))
    can_activate = (
        valid
        & ((tr.status == S.IPS_GOOD) | (tr.status == S.IPS_SKIPPED)
           | (tr.status == S.IPS_BADCONDITION) | (tr.status == S.IPS_OOB))
        & (tr.last_interval < 8.0)
        & (tr.quality > cfg.min_trace_quality)
        & (tr.idepth_max + tr.idepth_min > 0)
    )
    valid = valid & ~(~can_activate & (tr.status == S.IPS_OOB))

    # distance-map gating at half resolution (Mapping.cpp:405-420)
    R_f, t_f = W.frame_poses(frames)
    half_K = level_intrinsics(calib, 1)
    Ri, ti = lie.se3_inverse(R_f, t_f)
    R_rel = R_f[new_slot][None] @ Ri
    t_rel = (R_f[new_slot] @ ti[..., None])[..., 0] + t_f[new_slot][None]
    fx, fy, cx, cy = calib.value[0], calib.value[1], calib.value[2], calib.value[3]

    def project(u, v, idepth, host):
        dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
        h = _hslot(host, F)
        p3 = (R_rel[h] @ dirs[..., None])[..., 0] + t_rel[h] * idepth[:, None]
        z = torch.where(p3[:, 2].abs() < 1e-9, torch.full_like(p3[:, 2], 1e-9), p3[:, 2])
        return half_K[0] * p3[:, 0] / z + half_K[2], half_K[1] * p3[:, 1] / z + half_K[3], z

    su, sv, z = project(pts.u, pts.v, pts.idepth, pts.host)
    seed_ok = (pts.status == W.PT_ACTIVE) & (z > 0) & (su >= 0) & (sv >= 0) & (su < w2) & (sv < h2)
    dmap = dist_ops.distance_map(su, sv, seed_ok, h2, w2)

    idm = 0.5 * (tr.idepth_max + tr.idepth_min)
    cu, cv, zi = project(imm.u, imm.v, idm, imm.host)
    inb = (cu > 0) & (cv > 0) & (cu < w2) & (cv < h2) & (zi > 0)
    cui = torch.clamp(torch.round(cu).long(), 0, w2 - 1)
    cvi = torch.clamp(torch.round(cv).long(), 0, h2 - 1)
    dist_at = dmap[cvi, cui] + (cu - torch.floor(cu))
    gate = dist_at >= act_dist * imm.my_type
    to_opt = can_activate & inb & gate
    valid = valid & (inb | ~can_activate)

    act = act_ops.activate_points(frames, calib, imm.u, imm.v, idm, imm.color,
                                  imm.weight, imm.host, to_opt, cfg=cfg)

    N = imm.u.shape[0]
    slots, write = assign_free_slots(pts.status == W.PT_EMPTY, act.ok)

    def put(arr, vals):
        return scatter_update(arr, slots, write, vals)

    zN = torch.zeros_like(imm.u)
    zNF = torch.zeros((N, F), device=imm.u.device)
    newpts = pts._replace(
        status=put(pts.status, torch.full_like(slots, W.PT_ACTIVE)),
        host=put(pts.host, imm.host), u=put(pts.u, imm.u), v=put(pts.v, imm.v),
        idepth=put(pts.idepth, act.idepth), idepth_zero=put(pts.idepth_zero, act.idepth),
        color=put(pts.color, imm.color), weight=put(pts.weight, imm.weight),
        prior=put(pts.prior, zN), num_good_res=put(pts.num_good_res, torch.zeros_like(slots)),
        max_rel_baseline=put(pts.max_rel_baseline, zN), kp_idx=put(pts.kp_idx, imm.kp_idx),
        ind_u=put(pts.ind_u, zNF), ind_v=put(pts.ind_v, zNF), ind_w=put(pts.ind_w, zNF),
        ind_valid=put(pts.ind_valid, zNF.bool()),
    )
    return window._replace(points=newpts), imm._replace(valid=valid & ~to_opt)


def flag_and_marg_points(window: W.Window, calib: Calib, flag_mask: torch.Tensor,
                         cfg: Config, mesh=None):
    """flagPointsForRemoval + marginalizePointsF with the isOOB policy of
    MapPoint.h:133-161, point-sharded over `mesh` when one is given.
    Returns (window, removed_per_host, conn_marg)."""
    pts, frames = window.points, window.frames
    F = frames.valid.shape[0]
    active = pts.status == W.PT_ACTIVE
    res_in = pts.res_state == W.RES_IN
    n_res = res_in.sum(1)
    vis_in_marg = (res_in & flag_mask[None, :]).sum(1)
    drop_nores = active & ((pts.idepth < 0) | (n_res == 0))
    h = _hslot(pts.host, F)
    host_flagged = flag_mask[h]

    order = torch.argsort(torch.where(frames.valid, frames.kf_id,
                                      torch.full_like(frames.kf_id, -1)), stable=True)
    newest_slot = order[-1]
    second_slot = torch.where(frames.valid.sum() >= 2, order[-2], order[-1])
    trace.count("host_sync", 2)        # indexing by device scalars reads them
    last0 = pts.res_state[:, newest_slot]
    last1 = pts.res_state[:, second_slot]
    is_oob = (
        ((n_res >= cfg.min_good_active_res_for_marg)
         & (pts.num_good_res > cfg.min_good_res_for_marg + 10)
         & (n_res - vis_in_marg < cfg.min_good_active_res_for_marg))
        | (last0 == W.RES_OOB)
        | ((n_res >= 2) & (last0 == W.RES_OUT) & (last1 == W.RES_OUT))
    )
    affected = active & ~drop_nores & (is_oob | host_flagged)
    inlier = ((n_res >= cfg.min_good_active_res_for_marg)
              & (pts.num_good_res >= cfg.min_good_res_for_marg))
    well = pts.idepth_hessian > cfg.min_idepth_h_marg
    to_marg = affected & inlier & well
    to_drop = (affected & (~inlier | ~well)) | drop_nores

    removed = to_marg | to_drop
    removed_host = torch.zeros(F, dtype=torch.int32, device=h.device)
    removed_host.index_add_(0, h, removed.to(torch.int32))
    onehot = torch.nn.functional.one_hot(h, F).float()
    conn_marg = (onehot.T @ (res_in & to_marg[:, None]).float()).to(torch.int32)
    if mesh is None:
        wnd = marginalize_points(window, calib, to_marg, to_drop, cfg)
    else:
        wnd = sharded_marginalize_points(mesh, window, calib, to_marg, to_drop, cfg)
    return wnd, removed_host, conn_marg


def sample_pattern(img, u, v, cfg: Config):
    """Pattern colors, gradient weights, gradient outer-product sums and a
    finiteness flag of selector picks (sample_pattern in system.py)."""
    pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=u.device)
    up = u[:, None] + pat[None, :, 0]
    vp = v[:, None] + pat[None, :, 1]
    col = bilinear(img[..., 0], up, vp)
    gx = bilinear(img[..., 1], up, vp)
    gy = bilinear(img[..., 2], up, vp)
    c = cfg.outlier_th_sum_component
    wgt = torch.sqrt(c / (c + gx ** 2 + gy ** 2))
    gxy = (gx * gy).sum(-1)
    gH = torch.stack([torch.stack([(gx * gx).sum(-1), gxy], -1),
                      torch.stack([gxy, (gy * gy).sum(-1)], -1)], -2)
    return col, wgt, gH, torch.isfinite(col).all(-1)


def insert_new_traces(imm: Imm, slot: int, sel_u, sel_v, sel_type, sel_valid,
                      dir0, cfg: Config, sel_kp=None) -> Imm:
    """makeNewTraces: sample the picks' patterns and insert fresh
    candidates into free slots. `sel_kp` links keypoint-hosted candidates
    to the keyframe's feature table (-1 for gradient-selected ones)."""
    col, wgt, gH, finite = sample_pattern(dir0, sel_u, sel_v, cfg)
    slots, write = assign_free_slots(~imm.valid, sel_valid & finite)

    def put(arr, vals):
        return scatter_update(arr, slots, write, vals)

    u = sel_u
    tr = imm.trace
    new_trace = epi_ops.TraceState(
        idepth_min=put(tr.idepth_min, torch.zeros_like(u)),
        idepth_max=put(tr.idepth_max, torch.full_like(u, float("inf"))),
        status=put(tr.status, torch.full_like(slots, epi_ops.IPS_UNINITIALIZED)),
        quality=put(tr.quality, torch.full_like(u, 10000.0)),
        last_u=put(tr.last_u, torch.full_like(u, -1.0)),
        last_v=put(tr.last_v, torch.full_like(u, -1.0)),
        last_interval=put(tr.last_interval, torch.zeros_like(u)),
    )
    return Imm(
        valid=put(imm.valid, torch.ones_like(sel_valid)),
        host=put(imm.host, torch.full_like(slots, slot)),
        u=put(imm.u, sel_u), v=put(imm.v, sel_v), color=put(imm.color, col),
        weight=put(imm.weight, wgt), gradH=put(imm.gradH, gH),
        my_type=put(imm.my_type, sel_type.float()),
        energy_th=put(imm.energy_th, torch.full_like(
            u, 8 * cfg.outlier_th * cfg.overall_energy_th_weight ** 2)),
        kp_idx=put(imm.kp_idx, torch.full_like(slots, -1) if sel_kp is None else sel_kp),
        trace=new_trace,
    )


def indirect_associate(window: W.Window, feats: ft.Feats, slot: int, cfg: Config,
                       ind_w_scale=None) -> W.Window:
    """Match every window keyframe's keypoints against the new keyframe's,
    and give each keypoint-hosted active point its matched keypoint in the
    new frame as a reprojection observation (the BA's ind_* factors).
    `ind_w_scale` scales the information weight by tracking health."""
    pts, frames = window.points, window.frames
    F = frames.valid.shape[0]
    NF = feats.u.shape[1]
    midx, mok = ft.match_pair(feats.desc, feats.valid, feats.desc[slot], feats.valid[slot],
                              max_dist=cfg.indirect_match_max_dist,
                              ratio=cfg.indirect_match_ratio)       # (F, NF)
    h = _hslot(pts.host, F)
    kp = torch.clamp(pts.kp_idx.long(), 0, NF - 1)
    j = midx[h, kp]                                                 # (P,)
    ok = (mok[h, kp] & (pts.kp_idx >= 0) & (pts.status == W.PT_ACTIVE)
          & frames.valid[h] & (pts.host != slot))
    lvl = feats.level[slot, j].float()
    w = cfg.indirect_weight / (cfg.ind_pyr_scale ** (2.0 * lvl))
    if ind_w_scale is not None:
        w = w * ind_w_scale

    def col(arr, vals):
        out = arr.clone()
        out[:, slot] = vals.to(arr.dtype)
        return out

    return window._replace(points=pts._replace(
        ind_u=col(pts.ind_u, feats.u[slot, j]), ind_v=col(pts.ind_v, feats.v[slot, j]),
        ind_w=col(pts.ind_w, w), ind_valid=col(pts.ind_valid, ok)))


def feats_with_slot(feats: ft.Feats, slot: int, new) -> ft.Feats:
    """A copy of the keypoint store with slot `slot` replaced (the tracking
    thread may read the old store while the mapper builds the new one)."""
    out = []
    for arr, val in zip(feats, new):
        arr = arr.clone()
        arr[slot] = val
        out.append(arr)
    return ft.Feats(*out)


def extract_feats(img: torch.Tensor, cfg: Config):
    """The keyframe feature extraction of the indirect layer (kf_step and
    relocalization use the same call)."""
    return ft.extract_multiscale(
        img, cfg.ind_pyr_levels, cfg.max_kf_features, float(cfg.min_th_fast),
        scale=cfg.ind_pyr_scale, do_subpix=cfg.do_subpix, use_fast_only=cfg.use_fast,
        min_grad=float(cfg.min_grad_hist_add))


def kf_step(window: W.Window, calib: Calib, imm: Imm, feats: ft.Feats,
            pyr: List[torch.Tensor], R_new, t_new, aff_new, exp_new, slot: int,
            kf_id: int, ref_slot: int, flag_mask: np.ndarray, act_dist: float,
            n_iter: int, sel_u, sel_v, sel_type, sel_valid, cfg: Config,
            ind_w_scale=None, mesh=None):
    """One keyframe insertion (AddKeyframe, Mapping.cpp:12-142). Returns
    (window, calib, imm, feats, template, ba_result, bundle).

    `mesh` (a `parallel.distributed.Mesh`): the windowed BA and the point
    marginalization run point-sharded over it (SLAMSystem(dist_mesh=...))."""
    F = cfg.max_frames
    dev = R_new.device
    frames = window.frames
    flag_np = np.asarray(flag_mask, bool)
    flag_t = torch.as_tensor(flag_np, device=dev)

    # 1. trace candidates into this frame
    with trace.span("kf.trace"):
        imm = imm._replace(trace=trace_candidates(
            imm, frames, calib.value, R_new, t_new, aff_new, exp_new, pyr[0], cfg))

    # 2. indirect frontend: keypoints + descriptors of the new keyframe
    if cfg.enable_indirect:
        with trace.span("kf.features"):
            ext = extract_feats(pyr[0][..., 0], cfg)
        feats = feats_with_slot(feats, slot, ext)
        kp_u, kp_v, kp_valid = ext[0], ext[1], ext[5]

    # 3. insert the new frame into `slot`
    scale = torch.as_tensor(FRAME_STATE_SCALE, device=dev)
    st = torch.zeros(8, device=dev)
    st[6] = aff_new[0] / scale[6]
    st[7] = aff_new[1] / scale[7]
    eth = frames.energy_th[ref_slot] if ref_slot >= 0 else torch.tensor(12.0 * 12.0 * 8.0, device=dev)
    fr = {k: v.clone() for k, v in frames._asdict().items()}
    fr["valid"][slot] = True
    fr["evalpt_R"][slot] = R_new
    fr["evalpt_t"][slot] = t_new
    fr["state"][slot] = st
    fr["state_zero"][slot] = st
    fr["exposure"][slot] = exp_new
    fr["prior"][slot] = torch.as_tensor(W.later_frame_prior(cfg), device=dev)
    fr["kf_id"][slot] = kf_id
    fr["images"][slot] = pyr[0]
    fr["energy_th"][slot] = eth
    window = window._replace(frames=W.Frames(**fr))

    # 4. activate candidate points
    window, imm = activate_candidates(window, calib, imm, slot, act_dist, cfg)

    # 4b. indirect association (hybrid layer)
    if cfg.enable_indirect:
        window = indirect_associate(window, feats, slot, cfg, ind_w_scale=ind_w_scale)

    # 5. optimize (point-sharded over the mesh when given)
    with trace.span("kf.ba"):
        if mesh is None:
            result: BAResult = ba_optimize(window, calib, cfg, n_iter)
        else:
            result = sharded_ba_optimize(mesh, window, calib, cfg, n_iter)
    window, calib = result.window, result.calib

    # 6. remove outliers (active points with no active residual)
    pts = window.points
    has_res = (pts.res_state == W.RES_IN).sum(1) > 0
    pts = pts._replace(status=torch.where((pts.status == W.PT_ACTIVE) & ~has_res,
                                          W.PT_EMPTY, pts.status).to(torch.int32))
    window = window._replace(points=pts)

    # 6b. connectivity snapshot
    h = _hslot(pts.host, F)
    onehot = torch.nn.functional.one_hot(h, F).float()
    res_in_f = ((pts.res_state == W.RES_IN) & (pts.status == W.PT_ACTIVE)[:, None]).float()
    conn_active = (onehot.T @ res_in_f).to(torch.int32)

    # 7. tracker template on the new reference
    weight = torch.sqrt(1e-3 / (result.HdiF + 1e-12))
    template = trk_ops.build_template(
        result.newest_proj_u, result.newest_proj_v, result.newest_proj_idepth,
        weight, result.newest_res_in & (pts.status == W.PT_ACTIVE), pyr)

    # 7b. keypoint depth lift: nearest valid level-0 template point within 3 px
    NF = cfg.max_kf_features
    if cfg.enable_indirect:
        kp_idepth, kp_d2 = trk_ops.nearest_template_depth(
            feats.u[slot], feats.v[slot], template.u[0], template.v[0],
            template.idepth[0], template.valid[0])
        kp_depth_ok = kp_d2 <= 9.0
    else:
        kp_idepth = torch.zeros(NF, device=dev)
        kp_depth_ok = torch.zeros(NF, dtype=torch.bool, device=dev)

    # 8. flag + marginalize points
    window, removed_host, conn_marg = flag_and_marg_points(window, calib, flag_t, cfg,
                                                           mesh=mesh)

    # 9. new candidate traces: keypoint-hosted candidates first (they carry
    # the descriptor link), then the selector picks
    if cfg.enable_indirect:
        n_kp = kp_u.shape[0]
        imm = insert_new_traces(
            imm, slot, torch.cat([kp_u, sel_u]), torch.cat([kp_v, sel_v]),
            torch.cat([torch.ones(n_kp, dtype=sel_type.dtype, device=dev), sel_type]),
            torch.cat([kp_valid, sel_valid]), pyr[0], cfg,
            sel_kp=torch.cat([torch.arange(n_kp, device=dev),
                              torch.full_like(sel_type, -1).long()]))
    else:
        imm = insert_new_traces(imm, slot, sel_u, sel_v, sel_type, sel_valid, pyr[0], cfg)

    # 10. marginalize flagged frames, drop their candidates and observations
    for s in range(F):
        if flag_np[s]:
            window = marginalize_frame(window, s, cfg)
    imm = imm._replace(valid=imm.valid & ~flag_t[_hslot(imm.host, F)])
    window = window._replace(points=window.points._replace(
        ind_valid=window.points.ind_valid & ~flag_t[None, :]))

    # policy bundle
    frames, pts = window.frames, window.points
    R_f, t_f = W.frame_poses(frames)
    pt_active = pts.status == W.PT_ACTIVE
    n_active_host = torch.zeros(F, dtype=torch.int32, device=dev)
    n_active_host.index_add_(0, _hslot(pts.host, F), pt_active.to(torch.int32))
    n_imm_host = torch.zeros(F, dtype=torch.int32, device=dev)
    n_imm_host.index_add_(0, _hslot(imm.host, F), imm.valid.to(torch.int32))
    bundle = KFBundle(
        rmse=result.rmse, valid=frames.valid, kf_id=frames.kf_id, Rwc=R_f, twc=t_f,
        aff=W.frame_affine(frames), exposure=frames.exposure, calib_value=calib.value,
        n_active=pt_active.sum(), n_active_host=n_active_host, n_imm_host=n_imm_host,
        sel_count=sel_valid.sum(), removed_host=removed_host,
        conn_active=conn_active, conn_marg=conn_marg,
        flow_ok=torch.where(frames.valid[:, None], torch.isfinite(t_f), True).all(),
        n_ind=(pts.ind_valid & pt_active[:, None] & frames.valid[None, :]).sum(),
        kp_idepth=kp_idepth, kp_depth_ok=kp_depth_ok,
    )
    return window, calib, imm, feats, template, result, bundle
