"""Each bucket's pack of codes and lengths into its staging buffers (span
"strsim.stage.pack": the native pack, or the numpy narrowing pack), ns a pair."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ns_per_pair(rec, "strsim.stage.pack")
