"""The pointwise products (B3 `modmul`) in the traced stretch as a share
of the card's memory rate: per tower and call two arrays read once and
one written once, over B3's device time and the published rate."""
from benchlib import roofline


def read(run):
    t, w = run.trace, run.trace_window
    if t is None:
        return None
    seconds, launches = t.kernels(*roofline.MODMUL_KERNELS)
    if not launches:
        return None
    nbytes = w.calls * roofline.modmul_bytes_per_call(run.n, run.towers, run.products_per_call)
    return roofline.share(nbytes, seconds, run.hbm_bytes_per_s)
