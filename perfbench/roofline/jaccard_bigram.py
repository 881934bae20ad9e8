"""jaccard_bigram: the bigram-multiset intersection, by histogram, and row equality (uncounted: a floor)."""
from perfbench.roofline import _counts as c

STATS = {"inter2": c.bigram_histograms, "eq": None}
LOOKUPS = {}
