"""Point-sharded window BA and point marginalization (port of
hslam_tpu/parallel/dist_ba.py).

Linearization, Hessian accumulation and the Schur elimination of inverse
depths are independent over points, so each rank takes its block of the
window's points (every field of `W.Points`, the JAX package's
`_points_spec`, hslam_tpu/parallel/dist_ba.py:31-41); the (4+8F)^2 camera
system and the Schur terms are summed over the mesh, every rank solves the
same small system, and the inverse-depth back-substitution stays on the
block. Frames, calibration and HM/bM are replicated. After a call the
per-point outputs are gathered back into full arrays on every rank; an
output the solver did not touch (the same tensor as its input block) is
taken from the full input without a collective.
"""
from __future__ import annotations

import torch

from ..config import CPARS, Config
from ..models import window as W
from ..models.calib import Calib
from ..models.optimizer import (BAResult, _prior_vectors, _residual_grid_mask,
                                _slot_mask, _stitched_delta, ba_optimize,
                                marginalize_points, solve_camera_system)
from ..ops import ba
from .distributed import Mesh, all_gather, psum


def _local_window(mesh: Mesh, wnd: W.Window) -> W.Window:
    blk = mesh.block(wnd.points.status.shape[0])
    return wnd._replace(points=W.Points(*(a[blk] for a in wnd.points)))


def _gather(mesh: Mesh, outs, local_ins, full_ins):
    """Full arrays of per-point outputs `outs` (this rank's blocks): an
    output that `is` its input block comes from the full input, the rest go
    through one all_gather."""
    todo = [i for i, (o, li) in enumerate(zip(outs, local_ins)) if o is not li]
    got = dict(zip(todo, all_gather([outs[i] for i in todo], mesh))) if todo else {}
    return [got.get(i, full) for i, full in enumerate(full_ins)]


def sharded_ba_optimize(mesh: Mesh, wnd: W.Window, calib: Calib, cfg: Config,
                        n_iter) -> BAResult:
    """The full windowed GN optimize (models/optimizer.ba_optimize: the
    convergence exit, sticky residual states, the FEJ re-fix of the newest
    keyframe, the energy thresholds, the final fixing pass) with the points
    sharded over `mesh`. Returns a replicated BAResult."""
    loc = _local_window(mesh, wnd)
    res = ba_optimize(loc, calib, cfg, n_iter, axis=mesh)
    per_point = ("newest_proj_u", "newest_proj_v", "newest_proj_idepth",
                 "newest_res_in", "HdiF")
    none = [None] * len(per_point)
    full = _gather(mesh, list(res.window.points) + [getattr(res, k) for k in per_point],
                   list(loc.points) + none, list(wnd.points) + none)
    n = len(W.Points._fields)
    return res._replace(window=res.window._replace(points=W.Points(*full[:n])),
                        **dict(zip(per_point, full[n:])))


def sharded_marginalize_points(mesh: Mesh, wnd: W.Window, calib: Calib,
                               to_marg, to_drop, cfg: Config) -> W.Window:
    """marginalize_points with the flagged points' Schur-reduced blocks
    summed over the mesh into the replicated HM/bM."""
    loc = _local_window(mesh, wnd)
    blk = mesh.block(to_marg.shape[0])
    out = marginalize_points(loc, calib, to_marg[blk], to_drop[blk], cfg, axis=mesh)
    full = _gather(mesh, list(out.points), list(loc.points), list(wnd.points))
    return out._replace(points=W.Points(*full))


def sharded_ba_step(mesh: Mesh, wnd: W.Window, calib: Calib, cfg: Config):
    """One point-sharded GN step. Returns (rmse, new frame states, idepth
    steps (P,)), replicated."""
    F = cfg.max_frames
    frames, points = wnd.frames, _local_window(mesh, wnd).points
    lin = ba.linearize(frames, points, calib, cfg)
    active = _residual_grid_mask(frames, points) & (lin.new_state == W.RES_IN)
    AH, AT = ba.compute_adjoints(frames)
    sys = ba.accumulate(lin, active, points.host, AH, AT, F)
    pt_active = (points.status == W.PT_ACTIVE) & (active.sum(1) > 0)
    H_sc, b_sc, HdiF = ba.schur_complement(sys, points.prior, pt_active)

    H, b, H_sc, b_sc, E = psum(
        (sys.H, sys.b, H_sc, b_sc, torch.where(active, lin.energy, 0.0).sum()), mesh)
    n_res = psum(active.sum(), mesh)

    ns_proj = ba.nullspace_projector(ba.nullspaces(frames), cfg.solver_mode_delta)
    prior_diag, prior_b = _prior_vectors(frames, calib, cfg)
    x = solve_camera_system(H, b, H_sc, b_sc, wnd.HM, wnd.bM, _stitched_delta(frames, calib),
                            prior_diag, prior_b, _slot_mask(frames), ns_proj,
                            cfg.fix_lambda, False, cfg)
    d_step = all_gather(ba.resubstitute(sys, HdiF, x), mesh)
    rmse = torch.sqrt(E / torch.clamp(8.0 * n_res, min=1.0))
    new_state = frames.state - x[CPARS:].reshape(F, 8) * frames.valid[:, None]
    return rmse, new_state, d_step
