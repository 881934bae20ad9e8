"""lcs_seq: the LCS length by the Allison-Dix bit-parallel recurrence."""
from perfbench.roofline import _counts as c

STATS = {"lcs_len": c.lcs}
LOOKUPS = {"lcs_len": c.word_steps}
