"""Each bucket's two staging buffers, pinned on a card (span
"strsim.stage.alloc", `utils/alloc.py:staging_empty`), ns a pair."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ns_per_pair(rec, "strsim.stage.alloc")
