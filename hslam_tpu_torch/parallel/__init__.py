"""Sharded solvers on torch.distributed (port of hslam_tpu/parallel/).

Execution model. The JAX package drives a mesh from one controller: one
`shard_map` over the devices of one process. torch.distributed runs one
process per rank, so the port is SPMD:

  * Replicated host policy (the sequential entry). Every rank builds the
    same `SLAMSystem`, feeds it the same frames and runs the same host
    policy. Random draws come from seeded `torch.Generator`s, so the window,
    the tracker and every keyframe decision are the same on every rank.
  * Rank 0's decisions (the threaded entries, `sequential=False`). Which
    frame the mapping thread keyframes, traces or drops, when a new tracker
    reference or a loop correction lands, and when a calibration fit
    reaches the window all depend on thread timing, which differs between
    processes. So rank 0 plays the JAX package's one controller: it tracks
    and decides, and sends each decision as a record on a Gloo group of
    each thread's own (`distributed.Channel`); the other ranks build their
    own pyramids, track nothing, and replay the records in order, so their
    collectives come in rank 0's order and their shells get rank 0's bits.
    The loop-closure worker takes its entries from the mapping thread in
    that order, and needs no record.
  * Point shards. At a sharded call rank r takes the contiguous block
    [r P/n, (r+1) P/n) of the window's points, the blocks of the JAX
    package's `P("points")` (hslam_tpu/parallel/dist_ba.py:31-41), and
    linearizes, accumulates and Schur-eliminates that block only. Edges
    (the pose graph) and landmark blocks (the global BA) shard the same way.
  * Reductions. What the JAX package `psum`s or `all_gather`s is a
    collective over the mesh's process group (`distributed.psum`,
    `distributed.all_gather`). After the call the per-point outputs are
    gathered back, so the window stays replicated, as the JAX package's
    global arrays are outside its `shard_map`.
  * Host decisions read reduced values only (the BA's convergence test,
    the CG stopping tests), so every rank takes the same branch: a rank
    that left a loop early would leave the others waiting in a collective.
  * No mesh, no change: with `axis=None` each solver computes exactly what
    it computes without this package.

`distributed.py` brings the process group up and holds the collectives;
`dist_ba.py` is the point-sharded window BA and point marginalization,
`dist_pose_graph.py` the edge-sharded Sim3 PCG, `global_ba.py` the
keyframe-block-sharded global BA, `dryrun.py` a multi-rank self-check.
"""
