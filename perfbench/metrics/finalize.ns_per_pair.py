"""Finalize and scatter: RunMetrics.finalize_wall_s over the pairs, ns a pair."""


def read(rec):
    calls = rec.phased()
    rows = sum(c.rows for c in calls)
    return sum(c.run_metrics.finalize_wall_s for c in calls) / rows * 1e9 if rows else None
