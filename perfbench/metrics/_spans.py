"""Shared by the readers of the program's spans and counters: the traced
run's calls, each with its own RunMetrics (`Record.phased()`), summed over
the run and put over the pairs. Each returns None where the run's
RunMetrics hold no spans or counters (a tree whose program has none)."""


def _spanned(rec):
    calls = [c for c in rec.phased() if getattr(c.run_metrics, "spans", None)]
    return calls, sum(c.rows for c in calls)


def ns_per_pair(rec, name):
    """The spans named `name`, summed, ns a pair."""
    calls, rows = _spanned(rec)
    if not rows:
        return None
    return sum(c.run_metrics.span_s(name) for c in calls) / rows * 1e9


def self_ns_per_pair(rec, name):
    """The spans named `name` less what their direct children cover, ns a pair."""
    calls, rows = _spanned(rec)
    if not rows:
        return None
    return sum(c.run_metrics.self_s(name) for c in calls) / rows * 1e9


def counter_per_pair(rec, name):
    """The counter `name`, summed over the calls, a pair."""
    calls, rows = _spanned(rec)
    if not rows:
        return None
    return sum(c.run_metrics.counters.get(name, 0) for c in calls) / rows
