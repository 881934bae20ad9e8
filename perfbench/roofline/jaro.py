"""jaro: the greedy match and its transpositions (m, t), one statistic pair."""
from perfbench.roofline import _counts as c

STATS = {"jaro_mt": c.jaro}
LOOKUPS = {"jaro_mt": c.jaro_word_steps}
