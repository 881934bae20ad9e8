"""Every row of every call that completed in the window (null, equal and
empty rows included) over the window's seconds. No cell of the benchmark
holds it end to end yet: a cell whose pace the device sets (not the host)
names it in `end_to_end` with its own bound and `workloads`."""


def read(rec):
    return sum(c.rows for c in rec.done()) / rec.window_s if rec.window_s > 0 else None
