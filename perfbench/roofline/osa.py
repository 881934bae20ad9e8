"""osa: the OSA distance by Hyyro's bit-parallel recurrence."""
from perfbench.roofline import _counts as c

STATS = {"osa_d": c.osa}
LOOKUPS = {"osa_d": c.word_steps}
