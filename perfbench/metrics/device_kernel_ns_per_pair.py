"""The kernels' time a pair costs: the summed device time of every kernel
event in the window (the plain torch forms on the card included; copies
and sets left out), over every row of every call that completed in it, ns
a pair."""


def read(rec):
    rows = sum(c.rows for c in rec.done())
    if rec.trace is None or not rows:
        return None
    kernel_s = rec.trace.kernel_s()
    return kernel_s / rows * 1e9 if kernel_s > 0 else None
