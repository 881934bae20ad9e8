"""levenshtein: the edit distance by Myers' bit-parallel recurrence."""
from perfbench.roofline import _counts as c

STATS = {"lev_d": c.myers}
LOOKUPS = {"lev_d": c.word_steps}
