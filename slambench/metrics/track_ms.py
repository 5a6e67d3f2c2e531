"""The tracker: a span around each outermost call of ops/tracker.track_step
(the pipelined entry: pyramid, motion hypotheses, batched scoring, the
coarse-to-fine LM) or track_coarse_multi (the sequential entry, whose
pyramid is built before it), synchronised at its end; mean ms per call."""
UNIT = "ms"
SOURCE = {"wrap": {"track": ["hslam_tpu_torch.ops.tracker:track_step",
                             "hslam_tpu_torch.ops.tracker:track_coarse_multi"]}}


def read(run):
    ms = run.span_ms("track")
    return sum(ms) / len(ms) if ms else None
