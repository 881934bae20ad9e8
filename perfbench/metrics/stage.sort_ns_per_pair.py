"""Each bucket's stable sort by la + lb (span "strsim.stage.sort"), ns a pair."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ns_per_pair(rec, "strsim.stage.sort")
