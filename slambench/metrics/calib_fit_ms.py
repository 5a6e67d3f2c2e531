"""The online calibration fit (models/photo_calib.calibrate): a span around
each call, synchronised at its end; mean ms per fit."""
UNIT = "ms"
SOURCE = {"wrap": {"calib_fit": ["hslam_tpu_torch.models.photo_calib:calibrate"]}}


def read(run):
    ms = run.span_ms("calib_fit")
    return sum(ms) / len(ms) if ms else None
