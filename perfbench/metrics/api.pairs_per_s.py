"""The closed loop's throughput in the traced run: every row of every call
that completed in the window over the window's seconds, under the profiler
and RunMetrics' spans. Both cells are host-bound, and the host of the card's
machine swings their pace by more than an end-to-end bound can hold, so they
report it here only (`pairs_per_s` is its untraced form, for a cell that
holds it end to end)."""


def read(rec):
    return sum(c.rows for c in rec.done()) / rec.window_s if rec.window_s > 0 else None
