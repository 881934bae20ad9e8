"""The top-k's host phases: spans "strsim.topk.encode" (both columns),
"strsim.topk.stage" (order, candidate indices, uploads) and
"strsim.topk.finish" (the plain route's rows back to query order), summed,
ns a pair (Q x C pairs a call)."""
from perfbench.metrics import _spans

SPANS = ("strsim.topk.encode", "strsim.topk.stage", "strsim.topk.finish")


def read(rec):
    calls, rows = _spans._spanned(rec)
    if not rows or not any(s.name == "strsim.topk" for c in calls for s in c.run_metrics.spans):
        return None
    return sum(_spans.ns_per_pair(rec, name) for name in SPANS)
