"""Pure-Python per-pair oracle for the five reference measures.

An independent scalar implementation of the reference semantics
(src/expressions/strsim.rs:109-345), the same as `strsim_tpu/ops/oracle.py`
for these five measures. It scores the host rows (small inputs under
`host_short_circuit_rows`, rows beyond the bucket ladder) and is the check
that the device path is exact.

  * per Unicode scalar value, not bytes (strsim.rs:133,138)
  * both empty or equal -> 1.0 for every measure (strsim.rs:128,182,288,324)
  * exactly one side empty -> 0.0 (levenshtein reaches it through its formula)
  * levenshtein = 1 - dist/max(len), unit costs (strsim.rs:146-160)
  * jaro: greedy windowed match with bound = max(len)/2 - 1, ordered-zip
    transposition count, integer t/2, len-1 special case (strsim.rs:197-243)
  * jaro-winkler: strict jaro > 0.7 gate, <=4-char prefix, 0.1 scale
    (strsim.rs:258-271)
  * jaccard / sorensen-dice: character-multiset folds (strsim.rs:297-343)

All arithmetic follows the reference's f64 evaluation order, so scores are
bit-for-float identical.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple


def levenshtein_distance(a: str, b: str) -> int:
    """Unit-cost edit distance over Unicode scalars (rolling two-row DP)."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev = list(range(lb + 1))
    for i in range(la):
        cur = [i + 1] + [0] * lb
        ai = a[i]
        for j in range(lb):
            sub = prev[j] if ai == b[j] else prev[j] + 1
            cur[j + 1] = min(sub, prev[j + 1] + 1, cur[j] + 1)
        prev = cur
    return prev[lb]


def levenshtein(a: str, b: str) -> float:
    if (not a and not b) or a == b:
        return 1.0
    return 1.0 - (levenshtein_distance(a, b) / max(len(a), len(b)))


def jaro_stats(a: str, b: str) -> Tuple[int, int]:
    """(m, t_raw): match count and raw transposition count (before //2).

    Scan a's chars in order (only the first len_b + bound of them); each takes
    the first unflagged equal b char in [i-bound, i+bound] within [0, len_b).
    """
    la, lb = len(a), len(b)
    bound = max(la, lb) // 2 - 1
    flagged_a = [False] * la
    flagged_b = [False] * lb
    m = 0
    for i in range(min(la, lb + bound)):
        for j in range(max(0, i - bound), min(i + bound, lb - 1) + 1):
            if a[i] == b[j] and not flagged_b[j]:
                m += 1
                flagged_a[i] = True
                flagged_b[j] = True
                break
    a_idx = [i for i, f in enumerate(flagged_a) if f]
    b_idx = [j for j, f in enumerate(flagged_b) if f]
    t = sum(1 for i, j in zip(a_idx, b_idx) if a[i] != b[j])
    return m, t


def jaro(a: str, b: str) -> float:
    if (not a and not b) or a == b:
        return 1.0
    if not a or not b:
        return 0.0
    la, lb = len(a), len(b)
    if la == 1 and lb == 1:
        return 1.0 if a == b else 0.0
    m, t = jaro_stats(a, b)
    if m == 0:
        return 0.0
    return (m / la + m / lb + (m - t // 2) / m) / 3.0


def shared_prefix_length(a: str, b: str) -> int:
    n = 0
    for ca, cb in list(zip(a, b))[:4]:
        if ca != cb:
            break
        n += 1
    return n


def jaro_winkler(a: str, b: str) -> float:
    js = jaro(a, b)
    if js > 0.7:
        return js + (shared_prefix_length(a, b) * 0.1 * (1.0 - js))
    return js


def _char_counts(a: str, b: str) -> Dict[str, Tuple[int, int]]:
    cnt_a, cnt_b = Counter(a), Counter(b)
    return {c: (cnt_a.get(c, 0), cnt_b.get(c, 0)) for c in set(cnt_a) | set(cnt_b)}


def multiset_intersection(a: str, b: str) -> int:
    return sum(min(x, y) for x, y in _char_counts(a, b).values())


def jaccard(a: str, b: str) -> float:
    if (not a and not b) or a == b:
        return 1.0
    if not a or not b:
        return 0.0
    num = 0
    den = 0
    for x, y in _char_counts(a, b).values():
        num += min(x, y)
        den += max(x, y)
    return num / den


def sorensen_dice(a: str, b: str) -> float:
    if (not a and not b) or a == b:
        return 1.0
    if not a or not b:
        return 0.0
    return 2.0 * multiset_intersection(a, b) / (len(a) + len(b))


ORACLES = {
    "levenshtein": levenshtein,
    "jaro": jaro,
    "jaro_winkler": jaro_winkler,
    "jaccard": jaccard,
    "sorensen_dice": sorensen_dice,
}
