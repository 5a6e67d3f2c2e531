"""Loop detection (models/loop_closure.LoopCloser.detect: BoW query, match,
two PnPs): the system's lc_detect_ms, every entry added in the window;
mean ms per detect."""
UNIT = "ms"
SOURCE = {"deque": ["lc_detect_ms"]}


def read(run):
    xs = run.deques.get("lc_detect_ms", [])
    return sum(xs) / len(xs) if xs else None
