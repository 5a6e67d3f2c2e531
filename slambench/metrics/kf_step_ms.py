"""The keyframe step with the window BA (models/kf_step.kf_step): a span
around each call, synchronised at its end; mean ms per call."""
UNIT = "ms"
SOURCE = {"wrap": {"kf_step": ["hslam_tpu_torch.models.kf_step:kf_step"]}}


def read(run):
    ms = run.span_ms("kf_step")
    return sum(ms) / len(ms) if ms else None
