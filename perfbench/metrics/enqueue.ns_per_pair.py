"""Each bucket's two uploads and every block's stat launches and stack, as
the host enqueues them (span "strsim.enqueue"), ns a pair."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ns_per_pair(rec, "strsim.enqueue")
