"""The closed loop's throughput in the traced run: every row of every call
that completed in the window over the window's seconds, under the profiler
and RunMetrics' laps (`pairs_per_s` in the untraced run, where a cell holds
it end to end)."""


def read(rec):
    return sum(c.rows for c in rec.done()) / rec.window_s if rec.window_s > 0 else None
