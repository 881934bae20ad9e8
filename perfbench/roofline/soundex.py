"""soundex: code equality; no operation count (bytes alone, a floor)."""

STATS = {"sdx_eq": None}
LOOKUPS = {}
