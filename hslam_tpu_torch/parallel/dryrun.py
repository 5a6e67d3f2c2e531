"""Multi-rank self-check of the sharded solvers (the port's counterpart of
__graft_entry__.dryrun_multichip).

    python -m hslam_tpu_torch.parallel.dryrun 2            # on the card
    python -m hslam_tpu_torch.parallel.dryrun 4 --device cpu

Spawns n ranks. Each runs one point-sharded windowed-BA optimize (the GN
loop with its convergence exit, sticky states, Schur, energy thresholds and
the FEJ re-fix) and asserts a finite rmse and a step that moved the
window, then one edge-sharded Sim3 PCG relaxation of a (6n+2)-node chain,
whose 6n+1 edges need padding, and asserts a chi^2 drop below a tenth. The
ranks must agree on every number. Left out: the weak-scaling timing of
HSLAM_DRYRUN_TIMING, which needs more than one card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import PATTERN, Config
from ..models import pose_graph as PG
from ..models import window as W
from ..models.calib import make_calib
from ..ops.pyramid import image_gradients
from ..utils import lie
from ..utils.interp import bilinear
from .dist_ba import sharded_ba_optimize
from .dist_pose_graph import sharded_optimize_pose_graph_pcg
from .distributed import Mesh, run_ranks


def ba_inputs(cfg: Config, height: int = 96, width: int = 128, seed: int = 0,
              device="cuda"):
    """A window of cfg.max_frames smooth synthetic frames at small poses and
    cfg.max_points active points hosted in frame 0 with inverse depth 0.5
    and the bootstrap's inverse-depth prior (__graft_entry__._build_ba_inputs
    with torch draws). Returns (window, calib)."""
    g = torch.Generator().manual_seed(seed)
    calib = make_calib(80.0, 80.0, width / 2 - 0.5, height / 2 - 0.5, width, height,
                       device=device)
    wnd = W.empty_window(cfg, height, width, device=device)
    F, P = cfg.max_frames, cfg.max_points
    # poses small enough that every frame keeps in-bounds residuals
    xi = torch.randn(F, 6, generator=g) * torch.tensor([0.02] * 3 + [0.005] * 3)
    xi[0] = 0.0
    R0, t0 = lie.se3_exp(xi)
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                            torch.arange(width, dtype=torch.float32), indexing="ij")
    imgs = []
    for f in range(F):
        I = 120.0 + 50.0 * torch.sin(0.1 * xs + 0.03 * f) * torch.cos(0.13 * ys - 0.05 * f)
        dx, dy = image_gradients(I)
        imgs.append(torch.stack([I, dx, dy], -1))
    priors = [W.first_frame_prior(cfg)] + [W.later_frame_prior(cfg)] * (F - 1)
    frames = wnd.frames._replace(
        valid=torch.ones(F, dtype=torch.bool), evalpt_R=R0, evalpt_t=t0,
        kf_id=torch.arange(F, dtype=torch.int32), images=torch.stack(imgs),
        prior=torch.as_tensor(np.stack(priors), dtype=torch.float32))
    u = 8.0 + torch.rand(P, generator=g) * (width - 16.0)
    v = 8.0 + torch.rand(P, generator=g) * (height - 16.0)
    pat = torch.as_tensor(PATTERN, dtype=torch.float32)
    color = bilinear(frames.images[0, :, :, 0], u[:, None] + pat[None, :, 0],
                     v[:, None] + pat[None, :, 1])
    points = wnd.points._replace(
        status=torch.ones(P, dtype=torch.int32), host=torch.zeros(P, dtype=torch.int32),
        u=u, v=v, idepth=torch.full((P,), 0.5), idepth_zero=torch.full((P,), 0.5),
        color=color, weight=torch.ones(P, 8),
        # without an inverse-depth prior the scale gauge is free and the
        # camera solve singular
        prior=torch.full((P,), cfg.idepth_fix_prior))
    to = lambda tree: type(tree)(*(x.to(device) for x in tree))  # noqa: E731
    return W.Window(frames=to(frames), points=to(points), HM=wnd.HM, bM=wnd.bM), calib


def _chain_graph(n_nodes: int, device, seed: int = 3) -> PG.PoseGraph:
    """A chain of perturbed Sim3 nodes with identity odometry edges."""
    g = torch.Generator().manual_seed(seed)
    R, t = lie.se3_exp(torch.randn(n_nodes, 6, generator=g) * 0.05)
    s = torch.exp(torch.randn(n_nodes, generator=g) * 0.01)
    E = n_nodes - 1
    meas = (np.ones(E), np.broadcast_to(np.eye(3), (E, 3, 3)), np.zeros((E, 3)))
    return PG.make_graph(s, R, t, np.ones(n_nodes, bool), np.arange(1, n_nodes),
                         np.arange(0, n_nodes - 1), meas, device=device)


def _rank_check(mesh: Mesh, device: str):
    if device == "cuda":
        torch.cuda.set_device(mesh.rank % torch.cuda.device_count())
        device = f"cuda:{torch.cuda.current_device()}"
    else:
        torch.set_num_threads(1)
    n = mesh.size
    cfg = Config(max_frames=4, max_points=16 * n, pyr_levels=2)
    wnd, calib = ba_inputs(cfg, height=32, width=32, device=device)
    res = sharded_ba_optimize(mesh, wnd, calib, cfg, 4)
    rmse = float(res.rmse)
    moved = float(torch.linalg.norm(res.window.frames.state - wnd.frames.state))
    assert np.isfinite(rmse), f"distributed BA produced a non-finite rmse {rmse}"
    assert moved > 1e-6, "distributed optimize produced a zero step"

    n_nodes = 6 * n + 2                  # 6n+1 edges: padding on every mesh size
    pg = _chain_graph(n_nodes, device)
    sol = sharded_optimize_pose_graph_pcg(mesh.split("edges"), pg, n_iters=4, cg_iters=200)
    zero = torch.zeros((n_nodes, 7), device=device)
    chi_in = float(torch.sum(PG.residuals(pg, zero) ** 2))
    chi_out = float(torch.sum(PG.residuals(pg._replace(s=sol[0], R=sol[1], t=sol[2]), zero) ** 2))
    assert np.isfinite(chi_out), "sharded pose graph produced a non-finite chi2"
    assert chi_out < 0.1 * chi_in, f"sharded pose graph failed to relax: {chi_in:.3g} -> {chi_out:.3g}"
    return rmse, moved, chi_in, chi_out, n_nodes


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """Run the check on `n_devices` spawned ranks; print and return the
    `ok` line. On the card every rank takes card rank % count; the backend
    is NCCL when there is a card for each rank, else Gloo."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass device=\"cpu\"")
    backend = "nccl" if device == "cuda" and torch.cuda.device_count() >= n_devices else "gloo"
    out = run_ranks(_rank_check, n_devices, args=(device,), backend=backend)
    if any(o != out[0] for o in out):
        raise AssertionError(f"ranks disagree: {out}")
    rmse, _, chi_in, chi_out, n_nodes = out[0]
    msg = (f"dryrun_multichip({n_devices}): ok, rmse={rmse:.3f}; edge-sharded pose graph "
           f"chi2 {chi_in:.3g} -> {chi_out:.3g} on {n_nodes} nodes")
    print(msg, flush=True)
    return msg


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    dryrun_multichip(a.n, device=a.device)
