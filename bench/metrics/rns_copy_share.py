"""Device time in operations other than the port's three NTT-lane kernels
(today the tower split's cat and the join's stack) over the device time
of all operations, in the traced stretch."""
from benchlib import roofline


def read(run):
    t = run.trace
    if t is None or t.device_s <= 0:
        return None
    port, count = t.kernels(*roofline.NTT_KERNELS, *roofline.MODMUL_KERNELS)
    return 100.0 * (t.device_s - port) / t.device_s if count else None
