"""RNS products completed in the measured window over the window's seconds
(host clock; the window ends with a synchronise, so every product issued
is done)."""


def read(run):
    w = run.window
    return w.products / w.seconds if w.calls and w.seconds > 0 else None
