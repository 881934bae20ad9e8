"""The API layer outside RunMetrics' four phases: the harness's wall of each
call minus its encode, classify, device and finalize laps, over the pairs,
ns a pair."""


def read(rec):
    calls = rec.phased()
    rows = sum(c.rows for c in calls)
    if not rows:
        return None
    rest = sum(c.wall_s - c.run_metrics.encode_wall_s - c.run_metrics.classify_wall_s
               - c.run_metrics.device_wall_s - c.run_metrics.finalize_wall_s for c in calls)
    return rest / rows * 1e9
