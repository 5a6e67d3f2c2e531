"""The tracking thread's waits for the card: host reads of device values
(the `host_sync` counter: .cpu(), float(), int(), bool(), .tolist() in
models/system, ops/tracker and the keyframe step's BA) made in the
window's frames, per `frame` span in the window."""
from slambench import program

UNIT = "syncs/frame"
SOURCE = {"program": {"spans": ["frame"], "counters": ["host_sync"]}}


def read(run):
    got = program.reading(run)
    n = 0 if got is None else len(got.frames)
    return got.counter_delta("host_sync") / n if n else None
