"""The window's RNS products as a share of the card's memory rate: the
least bytes the products need (a and b read once, c written once) over
the window's seconds times the published rate.  The count is the same
whatever implements the product, so it bounds every gain in polymul_per_s."""
from benchlib import roofline


def read(run):
    w = run.window
    per_call = roofline.polymul_bytes_per_call(run.n, run.towers, run.products_per_call, run.shared)
    return roofline.share(per_call * w.calls, w.seconds, run.hbm_bytes_per_s)
