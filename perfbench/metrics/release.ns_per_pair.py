"""Release: the call's encoded columns freed at its end, their pages given
back to the system (span "strsim.release"), ns a pair."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ns_per_pair(rec, "strsim.release")
