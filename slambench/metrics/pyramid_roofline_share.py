"""The pyramid kernel (csrc/pyramid.cu, pyramid_fused_kernel) against its
memory bound: the bytes one frame's pyramid must move (roofline.py: the
float32 rectified frame in, [I, dx, dy, |grad|^2] out at every level) at
the H100's 3.35 TB/s, over the kernel's mean device time in the profiled
stretch."""
from slambench.roofline import H100_HBM_BYTES_PER_S, pyramid_bytes

UNIT = "%"
SOURCE = {"profiler": True}
KERNEL = "pyramid_fused_kernel"


def read(run):
    if run.device is None:
        return None
    ds = [d for name, _, d in run.device.kernels if KERNEL in name]
    if not ds:
        return None
    w, h = run.cam.out_size
    need = pyramid_bytes(h, w, int(run.cfg["capacities"]["pyr_levels"]), 4)
    return 100.0 * (need / H100_HBM_BYTES_PER_S) / (sum(ds) / len(ds))
