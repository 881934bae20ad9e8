"""Bytes staged for the upload, padding included: counter "stage.bytes",
each bucket's n_pad x 2 x width x itemsize codes and 2 x n_pad x 4 lengths,
over the pairs."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.counter_per_pair(rec, "stage.bytes")
