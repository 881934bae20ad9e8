"""K23's share of its roofline, in %: the least time the card could take for
every call in the traced window (the call shape's `work`, as
`kernels_roofline` reads it: the cell's measure and the rows' lengths alone)
over the summed device time of K23's own kernel events (`topk_kernel` in
their name; the plain torch forms and copies left out)."""
from perfbench.metrics import kernels_roofline

KERNEL = "topk_kernel"


def read(rec):
    if rec.trace is None or rec.peaks is None:
        return None
    k23_s = sum(hi - lo for name, lo, hi, kind in rec.trace.device
                if kind == "kernel" and KERNEL in name) / 1e6
    if k23_s <= 0:
        return None
    return kernels_roofline.share(kernels_roofline.bound_s(rec)[0], k23_s)
