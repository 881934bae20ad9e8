"""Partition: the device rows parted into buckets by their longer side
on the ladder (span "strsim.partition", `pipeline.bucket_rows`), ns a pair."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ns_per_pair(rec, "strsim.partition")
