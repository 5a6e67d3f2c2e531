"""Rectification and the frame's round trip (ops/undistort.remap_image with
io/calib_io's table): the harness's own span around the raw frame's upload,
the remap and the rectified frame's return to the host, the card
synchronised before it; mean ms per frame."""
UNIT = "ms"
SOURCE = {"harness": ["rectify"]}


def read(run):
    ms = run.span_ms("rectify")
    return sum(ms) / len(ms) if ms else None
