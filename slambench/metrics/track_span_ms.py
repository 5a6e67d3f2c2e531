"""The tracker as the program times itself: the window's `track` spans
(models/system._track_new_coarse: hypotheses, scoring, the coarse-to-fine
LM, ending at the program's own pull of the result); mean ms per span."""
from slambench import program

UNIT = "ms"
SOURCE = {"program": {"spans": ["track"]}}


def read(run):
    got = program.reading(run)
    ms = [] if got is None else [1e-6 * (s.t1 - s.t0) for s in got.of("track", "window")]
    return sum(ms) / len(ms) if ms else None
