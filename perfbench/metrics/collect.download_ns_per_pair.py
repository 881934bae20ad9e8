"""Each bucket's download of its stats, the wait for the stream included
(span "strsim.collect.download"), ns a pair."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ns_per_pair(rec, "strsim.collect.download")
