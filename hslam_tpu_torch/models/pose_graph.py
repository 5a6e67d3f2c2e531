"""Sim(3) / SE(3) pose-graph optimization (port of
hslam_tpu/models/pose_graph.py).

  * states: world-to-keyframe Sim3 poses (s, R, t), updated by
    left-multiplied increments exp(delta_i);
  * edges: index pairs with Sim3 measurements of S_i * S_j^-1;
  * residuals r_e = log_sim3(S_meas_e^-1 * S_i * S_j^-1), batched;
  * Jacobians: per-edge (7, 14) blocks by forward-mode differentiation of
    the edge residuals at delta = 0 (torch.func.jvp, one pass). The
    dense solver places the blocks into the (7E, 7N) matrix that
    differentiating the whole residual vector would give, at a fraction
    of the work; the matrix-free solver uses the blocks as they are;
  * Gauss-Newton with diagonal damping, the gauge fixed by pinning
    keyframe 0 (and every invalid node); a dense solve for graphs of a few
    hundred keyframes, block-Jacobi preconditioned CG on the normal
    equations beyond that (O(E) memory).

With fix_scale=True the sigma component is pinned to zero and the same
machinery does SE3 relaxation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..parallel.distributed import psum
from ..utils import lie
from ..utils.segsum import SortedBins

# per-GN-iteration cap on each node's sim3 tangent step norm (trust region):
# real corrections move nodes by far less per iteration; an inconsistent
# edge otherwise explodes through exp()
MAX_NODE_STEP = 1.0


class PoseGraph(NamedTuple):
    # states: world-to-kf sim3 as (s (N,), R (N, 3, 3), t (N, 3))
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    valid: torch.Tensor       # (N,) bool
    # edges
    edge_i: torch.Tensor      # (E,) int64
    edge_j: torch.Tensor      # (E,)
    meas_s: torch.Tensor      # (E,) measured S_ij = S_i * S_j^-1
    meas_R: torch.Tensor      # (E, 3, 3)
    meas_t: torch.Tensor      # (E, 3)
    weight: torch.Tensor      # (E,) edge weights


def _perturbed(pg: PoseGraph, delta):
    """States S_i' = exp(delta_i) * S_i."""
    ds, dR, dt = lie.sim3_exp(delta)
    return pg.s * ds, dR @ pg.R, ds[:, None] * lie._mv(dR, pg.t) + dt


def _edge_error(si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """log(meas^-1 * S_i * S_j^-1), batched over leading dimensions."""
    s_ij, R_ij, t_ij = lie.sim3_mul(si, Ri, ti, *lie.sim3_inverse(sj, Rj, tj))
    return lie.sim3_log(*lie.sim3_mul(*lie.sim3_inverse(ms, mR, mt), s_ij, R_ij, t_ij))


def residuals(pg: PoseGraph, delta: torch.Tensor) -> torch.Tensor:
    """(E, 7) residuals at states perturbed by delta (N, 7)."""
    s, R, t = _perturbed(pg, delta)
    i, j = pg.edge_i, pg.edge_j
    return _edge_error(s[i], R[i], t[i], s[j], R[j], t[j], pg.meas_s, pg.meas_R, pg.meas_t)


def _edge_residual(delta_ij, si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """(..., 7) residuals of edges as a function of the perturbations of
    their two incident nodes, delta_ij = [delta_i (7) | delta_j (7)]."""
    dsi, dRi, dti = lie.sim3_exp(delta_ij[..., :7])
    dsj, dRj, dtj = lie.sim3_exp(delta_ij[..., 7:])
    return _edge_error(si * dsi, dRi @ Ri, dsi[..., None] * lie._mv(dRi, ti) + dti,
                       sj * dsj, dRj @ Rj, dsj[..., None] * lie._mv(dRj, tj) + dtj,
                       ms, mR, mt)


def edge_jacobians(pg: PoseGraph):
    """Per-edge Jacobian blocks of the unweighted residuals at delta = 0:
    (Ji, Jj), each (E, 7, 7), with respect to the perturbations of nodes
    edge_i and edge_j. One forward-mode pass over 14 copies of the edge
    set, copy k carrying the k-th unit tangent: every tensor keeps its
    batch dimensions, so no vmap is involved."""
    E = pg.edge_i.shape[0]
    i, j = pg.edge_i, pg.edge_j
    edges = tuple(x.expand((14,) + x.shape) for x in (
        pg.s[i], pg.R[i], pg.t[i], pg.s[j], pg.R[j], pg.t[j],
        pg.meas_s, pg.meas_R, pg.meas_t))
    f = dict(dtype=pg.t.dtype, device=pg.t.device)
    tangent = torch.eye(14, **f)[:, None, :].expand(14, E, 14)
    _, cols = torch.func.jvp(lambda d: _edge_residual(d, *edges),
                             (torch.zeros((14, E, 14), **f),), (tangent,))
    blk = cols.permute(1, 2, 0)                                   # (E, 7, 14)
    return blk[..., :7], blk[..., 7:]


def dense_jacobian(pg: PoseGraph) -> torch.Tensor:
    """(7E, 7N) Jacobian of the weighted, flattened residuals at delta = 0,
    assembled from the per-edge blocks."""
    N, E = pg.s.shape[0], pg.edge_i.shape[0]
    Ji, Jj = edge_jacobians(pg)
    sw = torch.sqrt(pg.weight)[:, None, None]
    J = torch.zeros((E, 7, N, 7), dtype=Ji.dtype, device=Ji.device)
    e = torch.arange(E, device=Ji.device)
    # each (edge, node) pair occurs once per line; a self-loop (edge_i ==
    # edge_j) adds both blocks into one place
    J[e, :, pg.edge_i] += Ji * sw
    J[e, :, pg.edge_j] += Jj * sw
    return J.reshape(E * 7, N * 7)


def _pinned(pg: PoseGraph) -> torch.Tensor:
    """Gauge: keyframe 0 and every invalid node stay where they are."""
    pin = ~pg.valid
    pin[0] = True
    return pin


def _apply_step(pg: PoseGraph, dx: torch.Tensor) -> PoseGraph:
    """Bound each node's tangent step (an inconsistent, wrong-match loop
    edge otherwise drives exp() of huge tangents into overflow and the next
    iteration into NaN), then left-multiply."""
    nrm = torch.linalg.norm(dx, dim=1, keepdim=True)
    dx = dx * torch.clamp(MAX_NODE_STEP / torch.clamp(nrm, min=1e-12), max=1.0)
    s, R, t = _perturbed(pg, dx)
    return pg._replace(s=s, R=R, t=t)


def optimize_pose_graph(pg: PoseGraph, n_iters: int = 10, lam: float = 1e-6,
                        fix_scale: bool = False):
    """Dense Gauss-Newton. Returns the updated (s, R, t)."""
    N = pg.s.shape[0]
    dev = pg.t.device
    mask = (~_pinned(pg)).repeat_interleave(7).to(pg.t.dtype)
    if fix_scale:
        mask = mask * ((torch.arange(N * 7, device=dev) % 7) != 6).to(mask.dtype)
    zero = torch.zeros((N, 7), dtype=pg.t.dtype, device=dev)
    for _ in range(n_iters):
        r0 = (residuals(pg, zero) * torch.sqrt(pg.weight)[:, None]).reshape(-1)
        J = dense_jacobian(pg) * mask[None, :]
        H = J.T @ J
        b = J.T @ r0
        H = H + torch.diag(torch.clamp(torch.diagonal(H) * lam, min=1e-8) + (1.0 - mask))
        dx = -torch.linalg.solve(H, b)
        pg = _apply_step(pg, (dx * mask).reshape(N, 7))
    return pg.s, pg.R, pg.t


def optimize_pose_graph_pcg(pg: PoseGraph, n_iters: int = 10, cg_iters: int = 150,
                            cg_tol: float = 1e-8, lam: float = 1e-6,
                            fix_scale: bool = False, stats: Optional[dict] = None,
                            axis=None):
    """Sparse pose-graph GN: never materializes J or H.

    Per GN iteration: the per-edge Jacobian blocks, then preconditioned CG
    on the normal equations with H x evaluated as one batched product over
    edges and sums into nodes (O(E) work and memory), and a block-Jacobi
    preconditioner (per-node 7x7 sums of the incident J^T J blocks, one
    batched inverse). The sums into nodes have a fixed order
    (utils/segsum.SortedBins, sorted once per call), so a run gives
    the same bits every time (C14). The CG loop tests its residual on the
    host every iteration, as the reference's while_loop does on the device:
    one host sync per CG iteration.

    `axis`: a `parallel.distributed.Mesh` when the edge arrays are this
    rank's block (parallel/dist_pose_graph.py). Node states stay
    replicated; every sum into nodes is summed over the mesh, so the CG
    residual, and the stopping test read from it, is the same on every rank.

    `stats`, when given, receives `cg_iterations` and `host_syncs` summed
    over the GN iterations.
    """
    N = pg.s.shape[0]
    dev, dt = pg.t.device, pg.t.dtype
    I7 = torch.eye(7, dtype=dt, device=dev)
    dim_ok = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        dim_ok[6] = 0.0
    node_mask = (~_pinned(pg)).to(dt)[:, None] * dim_ok[None, :]     # (N, 7)
    zero = torch.zeros((N, 7), dtype=dt, device=dev)
    n_cg = n_sync = 0
    E = pg.edge_i.shape[0]
    # the edges' two ends as one list of (edge, node) entries, sorted by node
    bins = SortedBins(torch.cat([pg.edge_i, pg.edge_j]), N)
    e_of = bins.order % E

    for _ in range(n_iters):
        ei, ej = pg.edge_i, pg.edge_j
        sw = torch.sqrt(pg.weight)
        r0 = residuals(pg, zero) * sw[:, None]                        # (E, 7)
        Ji, Jj = edge_jacobians(pg)
        Ji = Ji * sw[:, None, None]
        Jj = Jj * sw[:, None, None]
        JT = torch.cat([Ji, Jj]).transpose(1, 2)[bins.order]          # (2E, 7, 7) sorted

        def scat(y):
            """J^T y summed into nodes: (E, 7) -> (N, 7)."""
            return psum(bins.sum_sorted((JT @ y[e_of][..., None])[..., 0]).to(dt), axis)

        b = scat(r0) * node_mask

        # block-Jacobi preconditioner + GN damping (per-node 7x7)
        Pn = psum(bins.sum_sorted(JT @ JT.transpose(1, 2)).to(dt), axis)
        damp = torch.clamp(torch.diagonal(Pn, dim1=1, dim2=2) * lam, min=1e-8)
        # pinned dims get identity rows so the batched inverse stays sane
        mm = node_mask[:, :, None] * node_mask[:, None, :]
        Pn = Pn * mm + I7[None] * torch.where(node_mask[:, :, None] > 0,
                                              damp[..., None] * I7[None], I7[None])
        P_inv = torch.linalg.inv(Pn)

        def Hx(x):
            xm = x * node_mask
            y = (Ji @ xm[ei][..., None] + Jj @ xm[ej][..., None])[..., 0]
            return scat(y) * node_mask + damp * xm + x * (1 - node_mask)

        def psolve(v):
            return (P_inv @ v[..., None])[..., 0]

        # PCG for H dx = -b
        x = zero
        r = -b - Hx(x)
        z = psolve(r)
        p = z
        rz = torch.sum(r * z)
        k = 0
        while k < cg_iters:
            n_sync += 1
            if not float(torch.sum(r * r)) > cg_tol:                 # host sync
                break
            hp = Hx(p)
            alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-30)
            x = x + alpha * p
            r = r - alpha * hp
            z = psolve(r)
            rz_new = torch.sum(r * z)
            p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
            rz = rz_new
            k += 1
        n_cg += k
        pg = _apply_step(pg, x * node_mask)
    if stats is not None:
        stats["cg_iterations"] = n_cg
        stats["host_syncs"] = n_sync
    return pg.s, pg.R, pg.t


def pad_graph(pg: PoseGraph, n_nodes: int, n_edges: int) -> PoseGraph:
    """Pad a graph to fixed sizes. Padded nodes are identity poses marked
    invalid (both solvers pin invalid nodes); padded edges are weight-0
    identity self-loops on node 0 (zero residual and zero Jacobian rows, so
    they add nothing to b, H or the preconditioner)."""
    N = pg.s.shape[0]
    E = pg.edge_i.shape[0]
    if n_nodes < N or n_edges < E:
        raise ValueError(f"pad_graph: sizes ({n_nodes},{n_edges}) smaller "
                         f"than graph ({N},{E})")
    dn = n_nodes - N
    de = n_edges - E
    if dn == 0 and de == 0:
        return pg
    f = dict(dtype=pg.t.dtype, device=pg.t.device)
    eye = torch.eye(3, **f)
    zi = torch.zeros(de, dtype=pg.edge_i.dtype, device=pg.t.device)
    return PoseGraph(
        s=torch.cat([pg.s, torch.ones(dn, **f)]),
        R=torch.cat([pg.R, eye.expand(dn, 3, 3)]),
        t=torch.cat([pg.t, torch.zeros((dn, 3), **f)]),
        valid=torch.cat([pg.valid, torch.zeros(dn, dtype=torch.bool, device=pg.t.device)]),
        edge_i=torch.cat([pg.edge_i, zi]),
        edge_j=torch.cat([pg.edge_j, zi]),
        meas_s=torch.cat([pg.meas_s, torch.ones(de, **f)]),
        meas_R=torch.cat([pg.meas_R, eye.expand(de, 3, 3)]),
        meas_t=torch.cat([pg.meas_t, torch.zeros((de, 3), **f)]),
        weight=torch.cat([pg.weight, torch.zeros(de, **f)]),
    )


def bucket_size(n: int, lo: int = 32) -> int:
    """Smallest power of two >= n (minimum `lo`)."""
    b = lo
    while b < n:
        b *= 2
    return b


def make_graph(s, R, t, valid, edge_i, edge_j, meas, weight=None,
               device="cuda") -> PoseGraph:
    """meas: tuple (s (E,), R (E, 3, 3), t (E, 3)) of measured S_i * S_j^-1.
    Takes numpy arrays or tensors; the graph lives on `device`, float32."""
    def to(x, dtype=torch.float32):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))          # a writable copy
        return x.to(device=device, dtype=dtype)

    edge_i = to(edge_i, torch.int64)
    if weight is None:
        weight = torch.ones(edge_i.shape[0])
    return PoseGraph(
        s=to(s), R=to(R), t=to(t), valid=to(valid, torch.bool),
        edge_i=edge_i, edge_j=to(edge_j, torch.int64),
        meas_s=to(meas[0]), meas_R=to(meas[1]), meas_t=to(meas[2]), weight=to(weight))
