"""Loop closure: BoW place recognition, geometric verification and
pose-graph correction (port of hslam_tpu/models/loop_closure.py).

  1. every keyframe contributes ORB descriptors, quantized to BoW words
     (ops/bow.py) and appended to the database;
  2. a new keyframe queries the database (batched L1 scoring); candidates
     must beat a fraction of the best score among temporally adjacent
     keyframes and be temporally non-adjacent;
  3. candidates are verified by descriptor matching (ops/orb.py); the metric
     loop edge comes from PnP RANSAC (ops/pnp.py) on the candidate's stored
     keypoint depths observed in the query frame (a two-view pose is
     scale-free and degenerate for the near-zero-baseline revisits loops
     are made of), checked by the reverse solve;
  4. the keyframe pose graph is relaxed with the loop edge plus sequential
     odometry edges (models/pose_graph.py; beyond `dense_max_nodes` on a
     mesh, edge-sharded by parallel/dist_pose_graph.py), and the correction
     is handed back to the host to re-anchor shells and the active window.

The database lives on the host as numpy (it is policy state, read entry by
entry); scoring, matching, PnP and the relaxation run on `device`.

RANSAC draws: the JAX package seeds its two PnP solves with
PRNGKey(kf_id) and PRNGKey(kf_id + 7777); `detect` takes `samples` for
both so a test can feed those draws in, otherwise they come from a
torch.Generator seeded with the same integers.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import bow as bow_ops
from ..ops import orb as orb_ops
from ..ops import pnp as pnp_ops
from ..parallel.dist_pose_graph import sharded_optimize_pose_graph_pcg
from ..utils import trace
from . import pose_graph as pg_mod

_LC_DEBUG = os.environ.get("HSLAM_LC_DEBUG") == "1"


def _dbg(msg):
    if _LC_DEBUG:
        sys.stderr.write(f"[lc] {msg}\n")


@dataclasses.dataclass
class KeyframeEntry:
    kf_id: int
    shell_id: int
    bow: np.ndarray             # (n_words,) L1-normalized tf-idf vector
    desc: np.ndarray            # (M, 8) int32 words (the uint32 bits)
    kp_u: np.ndarray            # (M,)
    kp_v: np.ndarray
    valid: np.ndarray           # (M,)
    cam_to_world: np.ndarray    # (4, 4), updated after corrections
    kp_idepth: np.ndarray | None = None   # (M,) inverse depths (loop edges)
    kp_depth_ok: np.ndarray | None = None


@dataclasses.dataclass
class LoopResult:
    query_kf: int
    match_kf: int
    rel_R: np.ndarray           # match-cam -> query-cam: S_query * S_match^-1
    rel_t: np.ndarray
    rel_s: float
    n_inliers: int


def _se3(R, t):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _pose_error(E):
    """Translation norm and rotation angle of a 4x4 that should be I."""
    cos_r = (np.trace(E[:3, :3]) - 1.0) / 2.0
    return float(np.linalg.norm(E[:3, 3])), float(np.arccos(np.clip(cos_r, -1.0, 1.0)))


def _np(x):
    if isinstance(x, torch.Tensor):
        trace.count("host_sync")
        return x.detach().cpu().numpy()                          # host sync
    return np.asarray(x)


class LoopCloser:
    """Host-driven loop-closure manager."""

    def __init__(self, vocab: bow_ops.Vocabulary,
                 min_score_ratio: float = 0.75,
                 min_gap: int = 15,
                 min_inliers: int = 25,
                 dist_mesh=None,
                 min_loop_error_rel: float = 0.0,
                 consistency_th: int = 1):
        """`min_loop_error_rel`: only emit a loop whose measured transform
        disagrees with the current (drifted) estimate by more than this
        multiple of the run scale (the median consecutive-keyframe
        baseline: monocular map units are arbitrary per run) in
        translation, or 0.3 rad in rotation; correcting below the PnP noise
        floor injects error instead of removing drift. `consistency_th`:
        consecutive keyframes that must agree on the candidate place before
        a loop fires. `dist_mesh` (a `parallel.distributed.Mesh`): graphs
        beyond `dense_max_nodes` relax edge-sharded over it. Tensors are made
        on the vocabulary's device."""
        self.vocab = vocab
        self.device = vocab.centroids.device
        self.entries: List[KeyframeEntry] = []
        self.min_score_ratio = min_score_ratio
        self.min_gap = min_gap
        self.min_inliers = min_inliers
        self.min_loop_error_rel = min_loop_error_rel
        self.min_loop_rot = 0.3            # rad; scale-free, stays absolute
        self.consistency_th = consistency_th
        # forward/reverse PnP transforms must invert each other within this
        # run-scale multiple (translation) / these radians (rotation)
        self.mutual_tol_rel = 0.8
        self.mutual_rot_tol = 0.05
        self._prev_cand_kf: Optional[int] = None
        self._consist_count = 0
        # geometrically verified (mutual-PnP-consistent) loops whose
        # correction was refused only by the significance gate: a low-drift
        # run rightly closes 0 loops, and this shows the chain was live
        self.n_verified_insignificant = 0
        # the gate that ended each detect() call, counted by name ("fired"
        # when a loop came out); HSLAM_LC_DEBUG=1 prints each decision
        self.gate_counts: collections.Counter = collections.Counter()
        # matrix-free relaxations edge-sharded over this mesh when one is set
        self.dist_mesh = dist_mesh
        # graphs up to this many nodes relax with the dense GN solver;
        # larger ones use matrix-free PCG
        self.dense_max_nodes = 512

    def run_scale(self) -> float:
        """Median consecutive-entry camera baseline: the per-run unit that
        normalizes the translation gates."""
        if len(self.entries) < 2:
            return 1.0
        c = np.stack([e.cam_to_world[:3, 3] for e in self.entries])
        d = np.linalg.norm(np.diff(c, axis=0), axis=1)
        d = d[d > 1e-9]
        if d.size == 0:
            return 1.0
        return float(max(np.median(d), 1e-6))

    def _dev(self, x, dtype=torch.float32):
        return torch.from_numpy(np.array(x)).to(device=self.device, dtype=dtype)

    def _score(self, q_bow, vecs):
        """L1 scores of `q_bow` against a list of BoW vectors."""
        return _np(bow_ops.l1_score(self._dev(q_bow), self._dev(np.stack(vecs))))

    def add_keyframe(self, kf_id: int, shell_id: int, desc, kp_u, kp_v, valid,
                     cam_to_world: np.ndarray, kp_idepth=None, kp_depth_ok=None):
        """desc (M, 8) int32, kp_u/kp_v/valid (M,): tensors or numpy."""
        desc, valid = _np(desc), _np(valid)
        words = bow_ops.quantize(self.vocab, self._dev(desc, torch.int32),
                                 self._dev(valid, torch.bool))
        vec = bow_ops.bow_vector(words, self.vocab.n_words, idf=self.vocab.idf)
        self.entries.append(KeyframeEntry(
            kf_id=kf_id, shell_id=shell_id, bow=_np(vec), desc=desc,
            kp_u=_np(kp_u), kp_v=_np(kp_v), valid=valid,
            cam_to_world=np.array(cam_to_world, np.float64),
            kp_idepth=None if kp_idepth is None else _np(kp_idepth),
            kp_depth_ok=None if kp_depth_ok is None else _np(kp_depth_ok),
        ))

    def _gate(self, name: str, msg: Optional[str] = None) -> None:
        self.gate_counts[name] += 1
        if msg is not None:
            _dbg(msg)

    def _reset_streak(self):
        self._prev_cand_kf = None
        self._consist_count = 0

    def _pnp(self, X, obs, valid, K, T_init, seed, samples):
        return pnp_ops.solve_pnp(
            self._dev(X), self._dev(obs), self._dev(valid, torch.bool), self._dev(K),
            seed=seed, min_inliers=self.min_inliers,
            init_R=self._dev(T_init[:3, :3]), init_t=self._dev(T_init[:3, 3]),
            samples=None if samples is None else self._dev(_np(samples), torch.int64))

    def detect(self, query_idx: int, K: np.ndarray, exclude_kfs=(),
               samples=None) -> Optional[LoopResult]:
        """Try to close a loop for entry `query_idx` (usually the newest).

        `exclude_kfs`: kf_ids covisible with the query per the keyframe
        connectivity map: a loop against a keyframe the window already
        shares residuals with adds no information and can short-circuit
        the min_gap check after marginalization reshuffles. `samples`:
        optional (forward, reverse) RANSAC draws, each (n_iters, 6)."""
        q = self.entries[query_idx]
        # an empty BoW vector (featureless frame) scores 0.5 against any
        # entry and 1.0 against another empty one under the L1 metric:
        # never let those drive candidate selection
        if float(np.abs(q.bow).sum()) < 1e-6:
            self._gate("empty query")
            self._reset_streak()
            return None
        cands = [
            i for i, e in enumerate(self.entries)
            if abs(e.kf_id - q.kf_id) >= self.min_gap
            and e.kf_id not in exclude_kfs
            and float(np.abs(e.bow).sum()) > 1e-6
        ]
        if not cands:
            # a streak from much earlier keyframes must not survive to let
            # a later one-shot candidate bypass the consistency gate
            self._gate("no candidate")
            self._reset_streak()
            return None
        scores = self._score(q.bow, [self.entries[i].bow for i in cands])

        # reference score from temporally adjacent keyframes
        adj = [e.bow for e in self.entries if 0 < abs(e.kf_id - q.kf_id) < 4]
        min_ref = (float(self._score(q.bow, adj).max()) * self.min_score_ratio
                   if adj else 0.05)

        best = int(np.argmax(scores))
        if _LC_DEBUG:
            top = np.argsort(scores)[::-1][:4]
            _dbg(f"q{q.kf_id}: qvalid {int(np.sum(q.valid))} cands " + " ".join(
                f"kf{self.entries[cands[i]].kf_id}:{scores[i]:.3f}" for i in top))
        if scores[best] < max(min_ref, 0.015):
            self._gate("score", f"q{q.kf_id}: score {scores[best]:.3f} < "
                                f"{max(min_ref, 0.015):.3f}")
            self._reset_streak()
            return None
        cand = self.entries[cands[best]]

        # temporal consistency: the same place must win on consecutive
        # keyframes before a loop fires; transient BoW flukes don't
        if self._prev_cand_kf is not None and abs(cand.kf_id - self._prev_cand_kf) <= 5:
            self._consist_count += 1
        else:
            self._consist_count = 1
        self._prev_cand_kf = cand.kf_id
        if self._consist_count < self.consistency_th:
            self._gate("consistency", f"q{q.kf_id}: cand kf{cand.kf_id} consistency "
                                      f"{self._consist_count}/{self.consistency_th}")
            return None

        # geometric verification: descriptor match (candidate -> query)
        idx_q, ok = orb_ops.match_descriptors(
            self._dev(cand.desc, torch.int32), self._dev(q.desc, torch.int32),
            valid_a=self._dev(cand.valid, torch.bool), valid_b=self._dev(q.valid, torch.bool))
        idx_np, ok_np = _np(idx_q), _np(ok)                       # host sync
        if ok_np.sum() < self.min_inliers:
            self._gate("matches", f"q{q.kf_id}: kf{cand.kf_id} matches {int(ok_np.sum())} < "
                                  f"{self.min_inliers}")
            return None

        # metric relative pose via PnP: lift the candidate's keypoints to 3D
        # with its stored inverse depths, observe them in the query frame
        if cand.kp_idepth is None:
            self._gate("depths")
            return None
        fx, fy = K[0, 0], K[1, 1]
        cx, cy = K[0, 2], K[1, 2]

        def lift(e):
            z = 1.0 / np.maximum(e.kp_idepth, 1e-6)
            return np.stack([(e.kp_u - cx) / fx * z, (e.kp_v - cy) / fy * z, z], -1)

        obs = np.stack([q.kp_u[idx_np], q.kp_v[idx_np]], -1)
        valid = ok_np & (cand.kp_depth_ok if cand.kp_depth_ok is not None
                         else np.ones_like(ok_np))
        if valid.sum() < self.min_inliers:
            self._gate("depths")
            return None
        s_fw, s_rv = samples if samples is not None else (None, None)
        # the current (drifted) estimate of the relative pose seeds the
        # solver: the 6-point DLT alone is degenerate on coplanar scenes
        T_init = np.linalg.inv(q.cam_to_world) @ cand.cam_to_world
        res = self._pnp(lift(cand), obs, valid, K, T_init, q.kf_id, s_fw)
        trace.count("host_sync")
        if not bool(res.ok):                                      # host sync
            self._gate("forward PnP", f"q{q.kf_id}: kf{cand.kf_id} forward PnP failed")
            return None
        trace.count("host_sync")
        n_inl = int(res.inliers.sum())                            # host sync
        T_fw = _se3(_np(res.R), _np(res.t))

        # mutual-consistency check: solve the REVERSE PnP (query keypoint
        # depths observed in the candidate frame) and require the two
        # transforms to invert each other. Pose from coplanar points has a
        # wrong-solution ambiguity that can carry near-full inlier support,
        # but the wrong solutions of the two directions do not invert each
        # other, so mutual consistency filters them where inlier counts
        # cannot.
        if q.kp_idepth is not None:
            dep_ok_q = (q.kp_depth_ok if q.kp_depth_ok is not None
                        else np.ones(len(q.kp_u), bool))
            valid_rev = ok_np & dep_ok_q[idx_np]
            if valid_rev.sum() < self.min_inliers:
                self._gate("depths")
                return None
            # seeded with the inverse of the FORWARD solution: the check asks
            # "does T_fw invert cleanly?", and a drifted seed fails the
            # reverse solve even for correct loops
            res_rev = self._pnp(lift(q)[idx_np], np.stack([cand.kp_u, cand.kp_v], -1),
                                valid_rev, K, np.linalg.inv(T_fw), q.kf_id + 7777, s_rv)
            trace.count("host_sync")
            if not bool(res_rev.ok):                              # host sync
                self._gate("reverse PnP", f"q{q.kf_id}: kf{cand.kf_id} reverse PnP failed")
                return None
            err_t, err_r = _pose_error(_se3(_np(res_rev.R), _np(res_rev.t)) @ T_fw)
            # translation tolerance in run-scale units; rotation is scale-free
            tol_t = self.mutual_tol_rel * self.run_scale()
            if err_t > tol_t or err_r > self.mutual_rot_tol:
                self._gate("mutual check", f"q{q.kf_id}: kf{cand.kf_id} mutual check failed "
                                           f"err_t={err_t:.4f} (tol {tol_t:.4f}) "
                                           f"err_r={err_r:.4f}")
                return None
            _dbg(f"q{q.kf_id}: kf{cand.kf_id} mutual ok err_t={err_t:.4f} err_r={err_r:.4f}")

        # significance gate: only correct when the measured loop transform
        # disagrees with the current (drifted) estimate by more than the PnP
        # noise floor; relaxing the whole chain with a stiff edge whose
        # "information" is measurement noise makes the trajectory worse
        if self.min_loop_error_rel > 0:
            err_t, err_r = _pose_error(np.linalg.inv(T_fw) @ T_init)
            min_t = self.min_loop_error_rel * self.run_scale()
            if err_t < min_t and err_r < self.min_loop_rot:
                # verified, but below the noise floor: counted, so that
                # "live, no correction warranted" and "dead" can be told apart
                self.n_verified_insignificant += 1
                self._gate("significance", f"q{q.kf_id}: kf{cand.kf_id} below significance "
                                           f"err_t={err_t:.4f} (min {min_t:.4f}) "
                                           f"err_r={err_r:.4f}")
                return None

        # a loop fires: the next one needs fresh consecutive agreement
        self._gate("fired")
        self._reset_streak()
        return LoopResult(query_kf=q.kf_id, match_kf=cand.kf_id,
                          rel_R=T_fw[:3, :3].copy(), rel_t=T_fw[:3, 3].copy(),
                          rel_s=1.0, n_inliers=n_inl)

    def correct(self, loop: LoopResult, fix_scale: bool = False
                ) -> List[Tuple[int, np.ndarray]]:
        """Relax the pose graph with sequential odometry edges + the loop
        edge. Returns [(shell_id, corrected cam_to_world)] for all entries
        and updates the stored entry poses; [] if the relaxation was
        rejected."""
        N = len(self.entries)
        kf_index = {e.kf_id: i for i, e in enumerate(self.entries)}
        # states: world-to-kf sim3 with s = 1
        Twc = np.stack([np.linalg.inv(e.cam_to_world) for e in self.entries])
        # sequential odometry edges between consecutive entries, then the
        # loop edge S_query * S_match^-1
        T_seq = Twc[1:] @ np.linalg.inv(Twc[:-1])
        edge_i = np.concatenate([np.arange(1, N), [kf_index[loop.query_kf]]])
        edge_j = np.concatenate([np.arange(0, N - 1), [kf_index[loop.match_kf]]])
        meas_s = np.concatenate([np.ones(N - 1), [loop.rel_s]])
        meas_R = np.concatenate([T_seq[:, :3, :3], np.asarray(loop.rel_R)[None]])
        meas_t = np.concatenate([T_seq[:, :3, 3], np.asarray(loop.rel_t)[None]])
        # capped: a raw inlier count can make one (possibly wrong) loop edge
        # hundreds of times stiffer than the odometry chain
        weight = np.concatenate([np.ones(N - 1), [float(min(loop.n_inliers, 50))]])
        pg = pg_mod.make_graph(np.ones(N), Twc[:, :3, :3], Twc[:, :3, 3], np.ones(N, bool),
                               edge_i, edge_j, (meas_s, meas_R, meas_t), weight,
                               device=self.device)
        # dense GN up to 512 keyframes, beyond that the matrix-free PCG path
        # (O(E) memory); the CG budget follows the power-of-two size class
        if N <= self.dense_max_nodes:
            s_new, R_new, t_new = pg_mod.optimize_pose_graph(pg, n_iters=8, fix_scale=fix_scale)
        elif self.dist_mesh is not None:
            s_new, R_new, t_new = sharded_optimize_pose_graph_pcg(
                self.dist_mesh, pg, n_iters=8,
                cg_iters=min(4 * pg_mod.bucket_size(N), 4000), fix_scale=fix_scale)
        else:
            s_new, R_new, t_new = pg_mod.optimize_pose_graph_pcg(
                pg, n_iters=8, cg_iters=min(4 * pg_mod.bucket_size(N), 4000),
                fix_scale=fix_scale)
        # acceptance gate: the relaxation must be finite AND have reduced
        # the weighted chi^2; a wrong-match loop edge can drive the solve
        # into divergence, and applying that "correction" destroys the map
        zero = torch.zeros((N, 7), device=self.device)
        wts = pg.weight[:, None]
        chi0 = torch.sum(wts * pg_mod.residuals(pg, zero) ** 2)
        chi1 = torch.sum(wts * pg_mod.residuals(
            pg._replace(s=s_new, R=R_new, t=t_new), zero) ** 2)
        s_np, R_np, t_np = (_np(x).astype(np.float64) for x in (s_new, R_new, t_new))
        trace.count("host_sync", 2)
        chi0, chi1 = float(chi0), float(chi1)                     # host sync
        if not (np.all(np.isfinite(s_np)) and np.all(np.isfinite(R_np))
                and np.all(np.isfinite(t_np))):
            return []
        if not np.isfinite(chi1) or chi1 >= chi0:
            return []
        out = []
        for i, e in enumerate(self.entries):
            # sim3 world-to-kf -> rigid cam_to_world with the scale folded
            # into the translation (the standard Strasdat correction)
            Tcw = np.linalg.inv(_se3(R_np[i], t_np[i] / max(s_np[i], 1e-8)))
            e.cam_to_world = Tcw
            out.append((e.shell_id, Tcw))
        return out
