"""The mapping thread: the system's kf_full_latencies (a keyframe's
dispatch to its finalized bundle, host seconds), every entry added in the
window; mean ms."""
UNIT = "ms"
SOURCE = {"deque": ["kf_full_latencies"]}


def read(run):
    xs = run.deques.get("kf_full_latencies", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
