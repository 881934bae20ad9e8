"""The call outside its parts: span "strsim.call" less its direct children
(encode, classify, host rows, partition, each bucket's stage and collect,
release), ns a pair."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.self_ns_per_pair(rec, "strsim.call")
