"""Sliding-window state (port of hslam_tpu/models/window.py).

Fixed-capacity masked struct-of-arrays with the JAX package's field names
and layouts, so states convert slot by slot (convert.py) and parity tests
compare like with like. Frame `state` is in solver units (natural =
FRAME_STATE_SCALE * state, ordered [t(3), r(3), a, b]); worldToCam =
se3_exp(natural xi) * evalPT. Points live on a dense (P, F) residual grid;
res_state: 0=IN, 1=OOB, 2=OUT. The `ind_*` fields of the hybrid indirect
layer are kept (all-False in the direct-only slice).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CPARS, FRAME_STATE_SCALE, Config
from ..utils import lie

RES_IN = 0
RES_OOB = 1
RES_OUT = 2

PT_EMPTY = 0
PT_ACTIVE = 1


class Frames(NamedTuple):
    valid: torch.Tensor        # (F,) bool
    evalpt_R: torch.Tensor     # (F, 3, 3) worldToCam FEJ rotation
    evalpt_t: torch.Tensor     # (F, 3)
    state: torch.Tensor        # (F, 8) solver-unit delta [t, r, a, b]
    state_zero: torch.Tensor   # (F, 8)
    exposure: torch.Tensor     # (F,)
    energy_th: torch.Tensor    # (F,)
    prior: torch.Tensor        # (F, 8)
    kf_id: torch.Tensor        # (F,) int32; -1 for empty slots
    images: torch.Tensor       # (F, H, W, 3) level-0 [I, dx, dy]


class Points(NamedTuple):
    status: torch.Tensor       # (P,) int32
    host: torch.Tensor         # (P,) int32 frame slot
    u: torch.Tensor
    v: torch.Tensor
    idepth: torch.Tensor
    idepth_zero: torch.Tensor
    color: torch.Tensor        # (P, 8)
    weight: torch.Tensor       # (P, 8)
    prior: torch.Tensor        # (P,)
    res_state: torch.Tensor    # (P, F) int32
    max_rel_baseline: torch.Tensor
    num_good_res: torch.Tensor  # (P,) int32
    idepth_hessian: torch.Tensor
    kp_idx: torch.Tensor       # (P,) int32
    ind_u: torch.Tensor        # (P, F)
    ind_v: torch.Tensor
    ind_w: torch.Tensor
    ind_valid: torch.Tensor    # (P, F) bool


class Window(NamedTuple):
    frames: Frames
    points: Points
    HM: torch.Tensor           # (D, D), D = 4 + 8 F
    bM: torch.Tensor           # (D,)


def state_dim(cfg: Config) -> int:
    return CPARS + 8 * cfg.max_frames


def empty_window(cfg: Config, height: int, width: int, device="cuda") -> Window:
    F, P = cfg.max_frames, cfg.max_points
    D = state_dim(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    frames = Frames(
        valid=torch.zeros(F, **b),
        evalpt_R=torch.eye(3, **f32).repeat(F, 1, 1),
        evalpt_t=torch.zeros((F, 3), **f32),
        state=torch.zeros((F, 8), **f32),
        state_zero=torch.zeros((F, 8), **f32),
        exposure=torch.ones(F, **f32),
        energy_th=torch.full((F,), 12.0 * 12.0 * 8.0, **f32),
        prior=torch.zeros((F, 8), **f32),
        kf_id=torch.full((F,), -1, **i32),
        images=torch.zeros((F, height, width, 3), **f32),
    )
    points = Points(
        status=torch.zeros(P, **i32),
        host=torch.zeros(P, **i32),
        u=torch.zeros(P, **f32),
        v=torch.zeros(P, **f32),
        idepth=torch.ones(P, **f32),
        idepth_zero=torch.ones(P, **f32),
        color=torch.zeros((P, 8), **f32),
        weight=torch.ones((P, 8), **f32),
        prior=torch.zeros(P, **f32),
        res_state=torch.full((P, F), RES_OOB, **i32),
        max_rel_baseline=torch.zeros(P, **f32),
        num_good_res=torch.zeros(P, **i32),
        idepth_hessian=torch.zeros(P, **f32),
        kp_idx=torch.full((P,), -1, **i32),
        ind_u=torch.zeros((P, F), **f32),
        ind_v=torch.zeros((P, F), **f32),
        ind_w=torch.zeros((P, F), **f32),
        ind_valid=torch.zeros((P, F), **b),
    )
    return Window(frames=frames, points=points, HM=torch.zeros((D, D), **f32),
                  bM=torch.zeros(D, **f32))


def frame_scale(device) -> torch.Tensor:
    return torch.as_tensor(FRAME_STATE_SCALE, device=device)


def frame_natural_state(frames: Frames) -> torch.Tensor:
    return frames.state * frame_scale(frames.state.device)


def frame_poses(frames: Frames):
    """Current worldToCam per frame: exp(natural xi) * evalPT."""
    nat = frame_natural_state(frames)
    dR, dt = lie.se3_exp(nat[:, :6])
    return lie.se3_mul(dR, dt, frames.evalpt_R, frames.evalpt_t)


def frame_affine(frames: Frames) -> torch.Tensor:
    return frame_natural_state(frames)[:, 6:8]


def frame_affine_zero(frames: Frames) -> torch.Tensor:
    return (frames.state_zero * frame_scale(frames.state.device))[:, 6:8]


def first_frame_prior(cfg: Config) -> np.ndarray:
    p = np.zeros(8, np.float32)
    p[0:3] = cfg.initial_trans_prior
    p[3:6] = cfg.initial_rot_prior
    p[6] = cfg.initial_aff_a_prior
    p[7] = cfg.initial_aff_b_prior
    return p


def later_frame_prior(cfg: Config) -> np.ndarray:
    p = np.zeros(8, np.float32)
    p[6] = cfg.affine_opt_mode_a if cfg.affine_opt_mode_a >= 0 else cfg.initial_aff_a_prior
    p[7] = cfg.affine_opt_mode_b if cfg.affine_opt_mode_b >= 0 else cfg.initial_aff_b_prior
    return p
