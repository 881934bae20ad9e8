"""jaro_winkler: jaro's (m, t) and the prefix capped at 4."""
from perfbench.roofline import _counts as c

STATS = {"jaro_mt": c.jaro, "prefix": c.prefix}
LOOKUPS = {"jaro_mt": c.jaro_word_steps}
