"""The top-k's download of [Q, k] indices and scores, the wait for the
device included (span "strsim.topk.collect"), ns a pair (Q x C pairs a
call)."""
from perfbench.metrics import _spans


def read(rec):
    calls, rows = _spans._spanned(rec)
    if not rows or not any(s.name == "strsim.topk" for c in calls for s in c.run_metrics.spans):
        return None
    return _spans.ns_per_pair(rec, "strsim.topk.collect")
