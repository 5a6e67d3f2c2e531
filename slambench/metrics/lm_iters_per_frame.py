"""The tracker's LM iterations (ops/tracker.track_coarse, the `lm_iter`
counter) made in the window's frames, per `track` span in the window."""
from slambench import program

UNIT = "iters/frame"
SOURCE = {"program": {"spans": ["frame", "track"], "counters": ["lm_iter"]}}


def read(run):
    got = program.reading(run)
    n = 0 if got is None else len(got.of("track", "window"))
    return got.counter_delta("lm_iter") / n if n else None
