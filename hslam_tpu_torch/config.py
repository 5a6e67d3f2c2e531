"""Global configuration (copy of hslam_tpu/config.py).

A copy, not an import: importing anything from hslam_tpu pulls jax in.
tests/test_torch_config.py pins the fields, defaults and constants to the
JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Residual pattern — the 8-pixel "SSE pattern" (reference: GlobalTypes.h:33,
# staticPattern[8] at GlobalTypes.h:193-203, padding 2).
# Offsets (dx, dy) around the point location.
# ---------------------------------------------------------------------------
PATTERN = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    dtype=np.int32,
)
PATTERN_NUM = 8
PATTERN_PADDING = 2

# Number of optimizable camera intrinsics (fx, fy, cx, cy).
# (reference: GlobalTypes.h:223 `CPARS = 4`)
CPARS = 4

# ---------------------------------------------------------------------------
# State scaling — diagonal preconditioner on the optimized state.
# The solver works in "scaled" units: x_actual = SCALE * x_scaled.
# (reference: GlobalTypes.h:34-50)
# ---------------------------------------------------------------------------
SCALE_IDEPTH = 1.0
SCALE_XI_TRANS = 0.5
SCALE_XI_ROT = 1.0
SCALE_F = 50.0
SCALE_C = 50.0
SCALE_A = 10.0
SCALE_B = 1000.0

# scaled 8-dof frame state: [t(3) * SXI_T, r(3) * SXI_R, a * SA, b * SB]
FRAME_STATE_SCALE = np.array(
    [SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3 + [SCALE_A, SCALE_B],
    dtype=np.float32,
)
CALIB_SCALE = np.array([SCALE_F, SCALE_F, SCALE_C, SCALE_C], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class Config:
    """Runtime knobs. Defaults reproduce the reference configuration
    (reference: Src/Settings.cpp)."""

    # ---- fixed capacities (TPU static shapes; not in reference) ----
    max_frames: int = 8           # window capacity (ref window max 7 + incoming)
    max_points: int = 2048        # active point capacity
    max_immature: int = 3072      # candidate point capacity
    max_features: int = 3072      # detector output capacity

    # ---- pyramid ----
    pyr_levels: int = 6           # direct pyramid levels (Settings.cpp:28)
    ind_pyr_levels: int = 4       # indirect (feature) pyramid levels
    ind_pyr_scale: float = 1.2

    # ---- hybrid indirect layer (per-keyframe multi-scale features +
    # matched-keypoint reprojection factors in the window BA; the declared
    # hybrid capability of the reference: Frame::CreateIndPyrs +
    # FeatureDetector + keypoint-hosted candidates) ----
    enable_indirect: bool = True
    max_kf_features: int = 512      # keypoint capacity per keyframe
    # schedule the indirect weight by tracking health: scale up (<=3x) as
    # the coarse tracker degrades against its per-reference baseline —
    # geometric terms carry more when the photometric model is stressed
    # (flicker, low texture); exactly 1x in the steady state
    indirect_weight_schedule: bool = True
    indirect_weight: float = 30.0   # info weight of a 1-px^2 residual at
                                    # octave 0, in photometric-energy units
    indirect_huber_px: float = 2.45  # ~sqrt(5.99) * sigma, ORB-SLAM chi2
    indirect_gate_px: float = 8.0    # hard association/activation gate
    indirect_match_max_dist: int = 64
    indirect_match_ratio: float = 0.8
    do_subpix: bool = False         # cornerSubPix keypoint refinement
                                    # (Detector.cpp:77-86, Settings.cpp:21)

    # ---- window / BA ----
    min_frames: int = 5           # Settings.cpp:57
    max_kf_frames: int = 7        # Settings.cpp:58 (logical window bound)
    max_opt_iterations: int = 6   # Settings.cpp:60
    min_opt_iterations: int = 1
    th_opt_iterations: float = 1.2
    force_accept_step: bool = True
    fix_lambda: float = 1e-5      # SOLVER_FIX_LAMBDA value (EnergyFunctional.cpp:708)
    solver_mode_delta: float = 1e-5
    orthogonalize_x_from_iter: int = 2  # SOLVER_ORTHOGONALIZE_X_LATER

    # ---- robust weighting ----
    huber_th: float = 9.0                     # Settings.cpp:68
    outlier_th: float = 12.0 * 12.0           # Settings.cpp:66
    outlier_th_sum_component: float = 50.0 * 50.0
    overall_energy_th_weight: float = 1.0

    # ---- adaptive frame energy threshold (Settings.cpp:74-77) ----
    frame_energy_th_n: float = 0.7
    frame_energy_th_fac_median: float = 1.5
    frame_energy_th_const_weight: float = 0.5

    # ---- priors (Settings.cpp:99-112); values apply to *scaled* state ----
    idepth_fix_prior: float = 50.0 * 50.0
    idepth_fix_prior_marg_fac: float = 600.0 * 600.0
    initial_rot_prior: float = 1e11
    initial_trans_prior: float = 1e10
    initial_aff_b_prior: float = 1e14
    initial_aff_a_prior: float = 1e14
    initial_calib_hessian: float = 5e9
    affine_opt_mode_a: float = 1e12   # >=0: optimize with prior
    affine_opt_mode_b: float = 1e8

    # ---- marginalization policy (Settings.cpp:52-55,81) ----
    max_log_aff_fac_in_window: float = 0.7
    min_points_remaining: float = 0.05
    marg_weight_fac: float = 0.25
    min_idepth_h_act: float = 100.0
    min_idepth_h_marg: float = 50.0
    min_good_active_res_for_marg: int = 3
    min_good_res_for_marg: int = 4

    # ---- coarse tracker (Settings.cpp:79, CoarseTracker.cpp) ----
    coarse_cutoff_th: float = 20.0
    re_track_threshold: float = 1.5
    tracker_iters_per_level: Tuple[int, ...] = (10, 20, 50, 50, 50, 50)

    # ---- immature point tracing (Settings.cpp:84-93) ----
    max_pix_search: float = 0.027
    min_trace_quality: float = 3.0
    trace_slack_interval: float = 1.5
    trace_step_size: float = 1.0
    trace_min_improvement_factor: float = 2.0
    trace_gn_iterations: int = 3
    trace_gn_threshold: float = 0.1
    trace_extra_slack_on_th: float = 1.2
    # cap on the discrete epipolar search. The reference allocates 100 slots
    # (ImmaturePoint.cpp:201-204) but the search length is already bounded by
    # maxPixSearch = 0.027 * (W + H) ~= 30 px at 640x480, i.e. <= ~32 steps
    # of stepsize 1 — 48 covers it with margin at 1/2 the gather cost.
    trace_max_steps: int = 48

    # ---- point activation ----
    gn_its_on_point_activation: int = 3
    desired_point_density: float = 2000.0     # Settings.cpp:121
    desired_immature_density: float = 1500.0

    # ---- keyframe decision (Settings.cpp:36-40) ----
    kf_weight_shift_t: float = 0.04 * (640 + 480)
    kf_weight_shift_r: float = 0.0 * (640 + 480)
    kf_weight_shift_rt: float = 0.02 * (640 + 480)
    kf_global_weight: float = 1.0
    max_affine_weight: float = 2.0

    # ---- detector ----
    num_features: int = 3000      # Settings.cpp:16
    min_th_fast: int = 8
    ssc_tolerance: float = 0.1
    enforced_min_dist: int = 5
    use_fast: bool = False
    min_grad_hist_cut: float = 0.5
    min_grad_hist_add: float = 7.0
    grad_downweight_per_level: float = 0.75
    select_direction_distribution: bool = True

    # ---- initializer ----
    init_slack_factor: float = 1.0
    init_ransac_iters: int = 200
    init_min_matches: int = 100
    # DirectRefinement photometric polish of the two-view result, with the
    # alphaW/alphaK translation prior + iR coupling + untriangulated 0.1x
    # down-weighting (Src/Initializer.cpp:1330-2314)
    init_direct_refine: bool = True

    # ---- misc ----
    seed: int = 0


DEFAULT_CONFIG = Config()
