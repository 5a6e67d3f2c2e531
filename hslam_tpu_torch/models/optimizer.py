"""Windowed BA: the GN loop, camera solve, marginalization (port of
hslam_tpu/models/optimizer.py: solve_camera_system, ba_optimize,
marginalize_points, marginalize_frame).

FEJ, forced step acceptance with the fixed lambda, sticky OOB within one
optimize() call, nullspace orthogonalization from iteration 2 on, and the
newest keyframe's evalPT re-set after the loop, as in the JAX module. The
GN `lax.while_loop` is a Python loop whose convergence test is one host
sync per iteration. The (D, D) camera system (D = 68 at 8 frames) is solved
with torch.linalg.solve_ex: a singular system yields non-finite entries,
which the NaN guard zeroes, instead of an exception.

`axis` (ba_optimize, marginalize_points): a `parallel.distributed.Mesh`
when the points are this rank's block of a point-sharded window
(parallel/dist_ba.py). Per-point work stays on the block; the camera
system, the convergence statistics, the energies and the energy quantile
are reduced over the mesh, as the JAX package's `psum`/`all_gather` over
its `axis`. With `axis=None` nothing is reduced.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CALIB_SCALE, CPARS, FRAME_STATE_SCALE, PATTERN_NUM, Config
from ..models import window as W
from ..models.calib import Calib
from ..ops import ba
from ..parallel.distributed import all_gather, psum
from ..utils import lie


class BAResult(NamedTuple):
    window: W.Window
    calib: Calib
    rmse: torch.Tensor
    newest_proj_u: torch.Tensor
    newest_proj_v: torch.Tensor
    newest_proj_idepth: torch.Tensor
    newest_res_in: torch.Tensor
    HdiF: torch.Tensor


def _t(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _stitched_delta(frames: W.Frames, calib: Calib):
    c_delta = (calib.value - calib.value_zero) / _t(CALIB_SCALE, calib.value)
    f_delta = (frames.state - frames.state_zero) * frames.valid[:, None]
    return torch.cat([c_delta, f_delta.reshape(-1)])


def _prior_vectors(frames: W.Frames, calib: Calib, cfg: Config):
    c_prior = torch.full((CPARS,), cfg.initial_calib_hessian, device=calib.value.device)
    c_delta = (calib.value - calib.value_zero) / _t(CALIB_SCALE, calib.value)
    f_prior = frames.prior * frames.valid[:, None]
    f_delta_prior = frames.state * frames.valid[:, None]
    prior_diag = torch.cat([c_prior, f_prior.reshape(-1)])
    prior_b = torch.cat([c_prior * c_delta, (f_prior * f_delta_prior).reshape(-1)])
    return prior_diag, prior_b


def _slot_mask(frames: W.Frames):
    fm = torch.repeat_interleave(frames.valid.float(), 8)
    return torch.cat([torch.ones(CPARS, device=fm.device), fm])


def solve_camera_system(H_top, b_top, H_sc, b_sc, HM, bM, delta, prior_diag,
                        prior_b, slot_mask, ns_proj, lam, do_orth_x: bool,
                        cfg: Config):
    """solveSystemF default path. Returns x (D,); steps are -x."""
    bM_top = bM + HM @ delta
    HFinal = H_top + torch.diag(prior_diag) + HM
    bFinal = b_top + prior_b + bM_top - b_sc
    d = torch.diagonal(HFinal)
    HFinal = HFinal + torch.diag(d * lam)
    HFinal = HFinal - H_sc * (1.0 / (1.0 + lam))
    m = slot_mask
    HFinal = HFinal * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    bFinal = bFinal * m
    dg = torch.diagonal(HFinal)
    HFinal = HFinal + torch.diag((dg.abs() < 1e-12).float())
    SVecI = 1.0 / torch.sqrt(torch.diagonal(HFinal).abs() + 10.0)
    Hs = HFinal * SVecI[:, None] * SVecI[None, :]
    bs = bFinal * SVecI
    sol, _ = torch.linalg.solve_ex(Hs, bs)
    x = SVecI * sol
    if do_orth_x:
        x = x - ns_proj @ x
    return x


def _apply_step(frames: W.Frames, calib: Calib, points: W.Points, x, d_step):
    F = frames.valid.shape[0]
    f_step = -x[CPARS:].reshape(F, 8) * frames.valid[:, None]
    frames = frames._replace(state=frames.state + f_step)
    calib = calib._replace(value=calib.value - x[:CPARS] * _t(CALIB_SCALE, x))
    active = points.status == W.PT_ACTIVE
    new_id = torch.where(active, points.idepth + d_step, points.idepth)
    points = points._replace(idepth=new_id, idepth_zero=new_id)
    return frames, calib, points, f_step


def _residual_grid_mask(frames: W.Frames, points: W.Points):
    F = frames.valid.shape[0]
    pa = (points.status == W.PT_ACTIVE)[:, None]
    not_host = points.host.long()[:, None] != torch.arange(F, device=pa.device)[None, :]
    return pa & frames.valid[None, :] & not_host


def _update_energy_th(frames: W.Frames, lin: ba.Linearization, grid,
                      newest_slot, cfg: Config, axis=None) -> W.Frames:
    """setNewFrameEnergyTH: 0.7-quantile of the residual energies into the
    newest frame, blended with a constant, squared. Under point-sharding
    (`axis`) the values are gathered first: the quantile is a global order
    statistic."""
    F = frames.valid.shape[0]
    dev = grid.device
    tgt_new = torch.arange(F, device=dev)[None, :] == newest_slot
    mask = grid & tgt_new & (lin.energy_raw >= 0)
    vals = torch.where(mask, lin.energy_raw, torch.full_like(lin.energy_raw, float("inf")))
    flat = torch.sort(all_gather(vals.reshape(-1), axis)).values
    n = psum(mask.sum(), axis)
    nth = torch.clamp((cfg.frame_energy_th_n * n.float()).to(torch.int64), 0,
                      flat.shape[0] - 1)
    nth_val = torch.sqrt(torch.clamp(flat[nth], min=0.0))
    th = nth_val * cfg.frame_energy_th_fac_median
    th = 26.0 * cfg.frame_energy_th_const_weight + th * (1.0 - cfg.frame_energy_th_const_weight)
    th = th * th * cfg.overall_energy_th_weight ** 2
    th = torch.where(n > 0, th, torch.full_like(th, 12.0 * 12.0 * PATTERN_NUM))
    new_th = torch.where(torch.arange(F, device=dev) == newest_slot, th, frames.energy_th)
    return frames._replace(energy_th=new_th)


def newest_slot_of(frames: W.Frames):
    return torch.argmax(torch.where(frames.valid, frames.kf_id,
                                    torch.full_like(frames.kf_id, -1)))


def ba_optimize(wnd: W.Window, calib: Calib, cfg: Config, n_iterations: int,
                frozen: Optional[ba.FrozenResiduals] = None, axis=None) -> BAResult:
    """The GN loop of one keyframe insertion (System::optimize). Under
    `axis` the camera system, the convergence statistics (so that every
    rank takes the same exit), the energy and the residual count are
    reduced over the mesh."""
    frames, points = wnd.frames, wnd.points
    F = frames.valid.shape[0]
    dev = frames.state.device
    newest_slot = newest_slot_of(frames)
    grid = _residual_grid_mask(frames, points)
    res_state = torch.where(grid, W.RES_IN, W.RES_OOB).to(torch.int32)
    ns_proj = ba.nullspace_projector(ba.nullspaces(frames), cfg.solver_mode_delta)
    slot_mask = _slot_mask(frames)
    lam = cfg.fix_lambda
    point_is_active = points.status == W.PT_ACTIVE

    for i in range(int(n_iterations)):
        AH, AT = ba.compute_adjoints(frames)
        lin = ba.linearize(frames, points, calib, cfg, window_gate=True)
        new_rs = torch.where(res_state == W.RES_OOB, W.RES_OOB, lin.new_state).to(torch.int32)
        active = (new_rs == W.RES_IN) & grid
        pt_phot = active.sum(1) > 0
        sys = ba.accumulate(lin, active, points.host, AH, AT, F,
                            ind_active=lin.ind_ok & grid & pt_phot[:, None])
        pt_active = point_is_active & pt_phot
        if frozen is not None:
            sys = ba.add_systems(sys, ba.accumulate_frozen(
                frozen, frames, calib, points.host, AH, AT, F))
            pt_active = pt_active | (point_is_active & frozen.is_linearized.any(1))
        H_sc, b_sc, HdiF = ba.schur_complement(sys, points.prior, pt_active)

        delta = _stitched_delta(frames, calib)
        prior_diag, prior_b = _prior_vectors(frames, calib, cfg)
        H, b, H_sc, b_sc = psum((sys.H, sys.b, H_sc, b_sc), axis)
        x = solve_camera_system(H, b, H_sc, b_sc, wnd.HM, wnd.bM, delta,
                                prior_diag, prior_b, slot_mask, ns_proj, lam,
                                i >= cfg.orthogonalize_x_from_iter, cfg)
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        d_step = ba.resubstitute(sys, HdiF, x)
        d_step = torch.where(torch.isfinite(d_step) & pt_active, d_step,
                             torch.zeros_like(d_step))
        frames, calib, points, f_step = _apply_step(frames, calib, points, x, d_step)
        res_state = new_rs

        nf = torch.clamp(frames.valid.sum(), min=1)
        sumA = (f_step[:, 6] ** 2).sum() / nf
        sumB = (f_step[:, 7] ** 2).sum() / nf
        sumT = (f_step[:, 0:3] ** 2).sum() / nf
        sumR = (f_step[:, 3:6] ** 2).sum() / nf
        npts = torch.clamp(psum(pt_active.sum(), axis), min=1)
        sumNID = psum(torch.where(pt_active, points.idepth.abs(),
                                  torch.zeros_like(points.idepth)).sum(), axis) / npts
        th = cfg.th_opt_iterations
        canbreak = ((torch.sqrt(sumA) < 0.0005 * th) & (torch.sqrt(sumB) < 0.00005 * th)
                    & (torch.sqrt(sumR) < 0.00005 * th)
                    & (torch.sqrt(sumT) * sumNID < 0.00005 * th))
        # canbreak (FullSystemOptimize.cpp:257-260)
        if i + 1 >= cfg.min_opt_iterations and bool(canbreak):    # host sync
            break

    # re-fix the newest frame's linearization point at its current pose
    nat = frames.state * _t(FRAME_STATE_SCALE, frames.state)
    dR, dt = lie.se3_exp(nat[:, :6])
    R_cur, t_cur = lie.se3_mul(dR, dt, frames.evalpt_R, frames.evalpt_t)
    is_new = torch.arange(F, device=dev) == newest_slot
    new_state = frames.state.clone()
    new_state[:, 0:6] = torch.where(is_new[:, None], 0.0, frames.state[:, 0:6])
    new_zero = torch.where(
        is_new[:, None],
        torch.cat([torch.zeros((F, 6), device=dev), new_state[:, 6:8]], dim=1),
        frames.state_zero)
    frames = frames._replace(
        evalpt_R=torch.where(is_new[:, None, None], R_cur, frames.evalpt_R),
        evalpt_t=torch.where(is_new[:, None], t_cur, frames.evalpt_t),
        state=new_state, state_zero=new_zero)

    # final pass: residual states, energy threshold, tracker projections
    AH, AT = ba.compute_adjoints(frames)
    lin = ba.linearize(frames, points, calib, cfg, window_gate=True)
    new_rs = torch.where(res_state == W.RES_OOB, W.RES_OOB, lin.new_state).to(torch.int32)
    active = (new_rs == W.RES_IN) & grid
    frames = _update_energy_th(frames, lin, grid, newest_slot, cfg, axis=axis)

    pt_phot = active.sum(1) > 0
    sys = ba.accumulate(lin, active, points.host, AH, AT, F,
                        ind_active=lin.ind_ok & grid & pt_phot[:, None])
    pt_active = point_is_active & pt_phot
    _, _, HdiF = ba.schur_complement(sys, points.prior, pt_active)

    tgt_new = torch.arange(F, device=dev)[None, :] == newest_slot
    new_in = (active & tgt_new).any(1)
    z = torch.zeros_like(lin.center_u)

    def at_new(x):
        return torch.where(tgt_new, x, z).sum(1)

    relbs_new = at_new(lin.rel_bs)
    points = points._replace(
        res_state=new_rs,
        num_good_res=points.num_good_res + new_in.to(torch.int32),
        idepth_hessian=sys.Hdd + points.prior,
        max_rel_baseline=torch.where(
            new_in, torch.maximum(points.max_rel_baseline, relbs_new),
            points.max_rel_baseline),
    )
    E_total = psum(torch.where(active, lin.energy, z).sum(), axis)
    n_res = torch.clamp(psum(active.sum(), axis), min=1)
    rmse = torch.sqrt(E_total / (PATTERN_NUM * n_res))
    return BAResult(
        window=W.Window(frames=frames, points=points, HM=wnd.HM, bM=wnd.bM),
        calib=calib, rmse=rmse, newest_proj_u=at_new(lin.center_u),
        newest_proj_v=at_new(lin.center_v),
        newest_proj_idepth=at_new(lin.center_idepth), newest_res_in=new_in,
        HdiF=HdiF)


def marginalize_points(wnd: W.Window, calib: Calib, to_marg, to_drop,
                       cfg: Config, axis=None) -> W.Window:
    """flagPointsForRemoval + marginalizePointsF: relinearize, extrapolate
    to the zero-delta point, fold margWeightFac * (M - Msc) into HM/bM.
    Under `axis` the folded blocks are summed over the mesh."""
    frames, points = wnd.frames, wnd.points
    F = frames.valid.shape[0]
    AH, AT = ba.compute_adjoints(frames)
    lin = ba.linearize(frames, points, calib, cfg, window_gate=True)
    grid = _residual_grid_mask(frames, points)
    active = grid & (lin.new_state == W.RES_IN) & to_marg[:, None]

    frozen = ba.fix_linearization(lin, frames, calib, points.host, active, AH, AT)
    dp, c_delta = ba.pair_deltas(frames, calib, AH, AT)
    jx, jy = ba._jp_delta(lin, ba._host_rows(dp, points.host), c_delta,
                          torch.zeros(points.u.shape[0], device=dp.device))
    lin = lin._replace(resF=frozen.res_toZero,
                       ind_res=lin.ind_res - torch.stack([jx, jy], dim=-1))
    ind_active = grid & lin.ind_ok & to_marg[:, None]

    sys = ba.accumulate(lin, active, points.host, AH, AT, F, ind_active=ind_active)
    marg_prior = points.prior * cfg.idepth_fix_prior_marg_fac
    pt_mask = to_marg & (active.sum(1) > 0)
    pt_mask = pt_mask & ((sys.Hdd + marg_prior) > cfg.min_idepth_h_marg)
    H_sc, b_sc, _ = ba.schur_complement(sys, marg_prior, pt_mask)

    active = active & pt_mask[:, None]
    ind_active = ind_active & pt_mask[:, None]
    sys = ba.accumulate(lin, active, points.host, AH, AT, F, ind_active=ind_active)

    H_top, b_top, H_sc_g, b_sc_g = psum((sys.H, sys.b, H_sc, b_sc), axis)
    HM = wnd.HM + cfg.marg_weight_fac * (H_top - H_sc_g)
    bM = wnd.bM + cfg.marg_weight_fac * (b_top - b_sc_g)
    new_status = torch.where(to_marg | to_drop, W.PT_EMPTY, points.status)
    return W.Window(frames=frames, points=points._replace(status=new_status.to(torch.int32)),
                    HM=HM, bM=bM)


def marginalize_frame(wnd: W.Window, slot: int, cfg: Config) -> W.Window:
    """EnergyFunctional::marginalizeFrame: add the frame's prior, then
    Schur-eliminate its 8 dims with the reference's diagonal scaling."""
    frames = wnd.frames
    F = frames.valid.shape[0]
    dev = wnd.HM.device
    idx8 = CPARS + 8 * slot + torch.arange(8, device=dev)
    HM = wnd.HM.clone()
    bM = wnd.bM.clone()
    prior = frames.prior[slot]
    HM[idx8, idx8] += prior
    bM[idx8] += prior * frames.state[slot]

    SVec = torch.sqrt(torch.diagonal(HM).abs() + 10.0)
    SVecI = 1.0 / SVec
    Hs = HM * SVecI[:, None] * SVecI[None, :]
    bs = bM * SVecI
    Hkk = Hs[idx8][:, idx8]
    Hak = Hs[:, idx8]
    bk = bs[idx8]
    Hkk = 0.5 * (Hkk + Hkk.T)
    Hkk_inv, _ = torch.linalg.inv_ex(Hkk)
    Hkk_inv = 0.5 * (Hkk_inv + Hkk_inv.T)
    Hs_new = Hs - Hak @ Hkk_inv @ Hak.T
    bs_new = bs - Hak @ (Hkk_inv @ bk)
    HM_new = Hs_new * SVec[:, None] * SVec[None, :]
    bM_new = bs_new * SVec
    HM_new = 0.5 * (HM_new + HM_new.T)
    keep = torch.ones(HM.shape[0], device=dev)
    keep[idx8] = 0.0
    HM_new = HM_new * keep[:, None] * keep[None, :]
    bM_new = bM_new * keep
    valid = frames.valid.clone()
    valid[slot] = False
    return W.Window(frames=frames._replace(valid=valid), points=wnd.points,
                    HM=HM_new, bM=bM_new)
