"""The entry's host policy (models/system.process_frame): the self time of
each of the window's `frame` spans, its length less the union of its child
spans (pyramid, track, calib.*, kf, nonkf, init); mean ms per frame."""
from slambench import program

UNIT = "ms"
SOURCE = {"program": {"spans": ["frame"]}}


def read(run):
    got = program.reading(run)
    return None if got is None else got.mean_self_ms()
