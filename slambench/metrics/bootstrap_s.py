"""The bootstrap (models/system._try_initialize: selection, KLT, two-view
reconstruction, direct refinement, the first keyframes): the sum of the
set-up's `init` spans, one per bootstrap frame, in seconds."""
from slambench import program

UNIT = "s"
SOURCE = {"program": {"spans": ["init"]}}


def read(run):
    got = program.reading(run)
    spans = [] if got is None else got.of("init", "setup")
    return 1e-9 * sum(s.t1 - s.t0 for s in spans) if spans else None
