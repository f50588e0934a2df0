"""The NTT launches (B1 `ntt_tile`, B2 `ntt_pair`) in the traced stretch
as a share of the card's memory rate: each launch's array read once and
written once, each transform's twiddle table once, over those launches'
device time and the published rate."""
from benchlib import roofline


def read(run):
    t, w = run.trace, run.trace_window
    if t is None:
        return None
    seconds, launches = t.kernels(*roofline.NTT_KERNELS)
    if not launches:
        return None
    per_transform = launches / (2 * run.towers * w.calls)
    nbytes = w.calls * roofline.ntt_bytes_per_call(run.n, run.towers, run.products_per_call, per_transform)
    return roofline.share(nbytes, seconds, run.hbm_bytes_per_s)
