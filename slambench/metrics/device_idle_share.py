"""The device: the share of the profiled stretch in which no operation ran
on the card (1 - the union of its kernels and copies over the stretch)."""
UNIT = "%"
SOURCE = {"profiler": True}


def read(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
