"""Edge-sharded Sim(3) pose-graph relaxation (port of
hslam_tpu/parallel/dist_pose_graph.py).

The matrix-free PCG of models/pose_graph.py does all its O(E) work in
per-edge Jacobian blocks and sums into nodes, so the edges split into
contiguous blocks over the mesh; every rank keeps the full replicated node
vectors (280 KB at 10^4 keyframes) and sums its gradient, preconditioner
and H x contributions over the mesh.
"""
from __future__ import annotations

import torch

from ..models.pose_graph import PoseGraph, optimize_pose_graph_pcg
from .distributed import Mesh


def pad_edges(pg: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge set to a multiple of the mesh size with zero-weight
    self-edges on node 0 (identity measurement): their residual is zero and
    their Jacobian is scaled by sqrt(weight) = 0, so they add nothing."""
    E = pg.edge_i.shape[0]
    pad = (-E) % multiple
    if pad == 0:
        return pg
    f = dict(dtype=pg.meas_t.dtype, device=pg.meas_t.device)
    zi = torch.zeros(pad, dtype=pg.edge_i.dtype, device=pg.edge_i.device)
    return pg._replace(
        edge_i=torch.cat([pg.edge_i, zi]),
        edge_j=torch.cat([pg.edge_j, zi]),
        meas_s=torch.cat([pg.meas_s, torch.ones(pad, **f)]),
        meas_R=torch.cat([pg.meas_R, torch.eye(3, **f).expand(pad, 3, 3)]),
        meas_t=torch.cat([pg.meas_t, torch.zeros((pad, 3), **f)]),
        weight=torch.cat([pg.weight, torch.zeros(pad, **f)]),
    )


def sharded_optimize_pose_graph_pcg(mesh: Mesh, pg: PoseGraph, n_iters: int = 10,
                                    cg_iters: int = 150, cg_tol: float = 1e-8,
                                    lam: float = 1e-6, fix_scale: bool = False,
                                    stats: dict | None = None):
    """optimize_pose_graph_pcg with this rank's block of the (padded) edges
    and every sum into nodes summed over the mesh. Returns the replicated
    (s, R, t), equal up to the order of the sums to the one-rank solver."""
    pg = pad_edges(pg, mesh.size)
    blk = mesh.block(pg.edge_i.shape[0])
    local = pg._replace(edge_i=pg.edge_i[blk], edge_j=pg.edge_j[blk],
                        meas_s=pg.meas_s[blk], meas_R=pg.meas_R[blk],
                        meas_t=pg.meas_t[blk], weight=pg.weight[blk])
    return optimize_pose_graph_pcg(local, n_iters=n_iters, cg_iters=cg_iters,
                                   cg_tol=cg_tol, lam=lam, fix_scale=fix_scale,
                                   stats=stats, axis=mesh)
