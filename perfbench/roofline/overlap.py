"""overlap: the character-multiset intersection, by histogram."""
from perfbench.roofline import _counts as c

STATS = {"inter": c.char_histograms}
LOOKUPS = {}
