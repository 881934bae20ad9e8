"""hamming: positional matches, one compare a position of the shorter side."""
from perfbench.roofline import _counts as c

STATS = {"ham_m": c.positions}
LOOKUPS = {}
