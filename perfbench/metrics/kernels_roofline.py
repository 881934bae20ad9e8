"""The kernels' share of their roofline, in %: the least time the card could
take for every call in the traced window (each call's least work from the
cell's call shape, `shapes/<shape>.py:work`, over `roofline/_bound.py`: the
cell's measures and the rows' lengths alone, never the program's routes)
over the summed device time of every kernel event in that window (the plain
torch forms on the card included; copies left out)."""
from perfbench.roofline import _bound


def bound_s(rec):
    """(least seconds, what bounds it) for the calls of the window."""
    nbytes = ops = 0.0
    per_input = {}
    w = rec.workload
    for c in rec.done():
        if c.input not in per_input:
            per_input[c.input] = w.shape.work(w.measures, w.inputs[c.input])
        b, o = per_input[c.input]
        nbytes += b
        ops += o
    return _bound.seconds(nbytes, ops, rec.peaks)


def share(bound: float, kernel_s: float) -> float:
    return bound / kernel_s * 100.0


def read(rec):
    if rec.trace is None or rec.peaks is None:
        return None
    kernel_s = rec.trace.kernel_s()
    if kernel_s <= 0:
        return None
    return share(bound_s(rec)[0], kernel_s)
