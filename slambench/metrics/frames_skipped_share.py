"""The mapping thread: frames it dropped to catch up (the system's
n_frames_skipped over the window) as a share of the frames handed over."""
UNIT = "%"
SOURCE = {"counter": ["n_frames_skipped"]}


def read(run):
    return 100.0 * run.counter_delta("n_frames_skipped") / run.attempted if run.attempted else None
