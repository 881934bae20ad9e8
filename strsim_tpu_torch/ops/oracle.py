"""Pure-Python per-pair oracle for the five reference measures and the nine
extensions.

An independent scalar implementation of the reference semantics
(src/expressions/strsim.rs:109-345), the same as `strsim_tpu/ops/oracle.py`
for these fourteen measures. It scores the host rows (small inputs under
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

  * extensions (not in the reference): bigram-multiset jaccard and
    sorensen-dice, character-multiset cosine and overlap, positional
    hamming, LCS similarity and indel, OSA (restricted Damerau-Levenshtein)
    and soundex code equality, with the conventions documented on each

All arithmetic follows the reference's f64 evaluation order, so scores are
bit-for-float identical.
"""
from __future__ import annotations

import math
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


def _bigrams(s: str):
    return [s[i : i + 2] for i in range(len(s) - 1)]


def bigram_intersection(a: str, b: str) -> int:
    ca, cb = Counter(_bigrams(a)), Counter(_bigrams(b))
    return sum(min(ca[g], cb.get(g, 0)) for g in ca)


def jaccard_bigram(a: str, b: str) -> float:
    """Bigram-multiset Jaccard: equal strings (length-1 pairs included) score
    1.0; a side without bigrams scores 0.0."""
    if a == b:
        return 1.0
    na, nb = max(len(a) - 1, 0), max(len(b) - 1, 0)
    if na == 0 or nb == 0:
        return 0.0
    inter = bigram_intersection(a, b)
    return inter / (na + nb - inter)


def sorensen_dice_bigram(a: str, b: str) -> float:
    """Bigram-multiset Sorensen-Dice (conventions of jaccard_bigram)."""
    if a == b:
        return 1.0
    na, nb = max(len(a) - 1, 0), max(len(b) - 1, 0)
    if na == 0 or nb == 0:
        return 0.0
    return 2.0 * bigram_intersection(a, b) / (na + nb)


def cosine(a: str, b: str) -> float:
    """Otsuka-Ochiai cosine over character multisets: inter / sqrt(la * lb)."""
    if (not a and not b) or a == b:
        return 1.0
    if not a or not b:
        return 0.0
    return multiset_intersection(a, b) / math.sqrt(len(a) * len(b))


def overlap(a: str, b: str) -> float:
    """Overlap (Szymkiewicz-Simpson) coefficient over character multisets:
    inter / min(la, lb)."""
    if (not a and not b) or a == b:
        return 1.0
    if not a or not b:
        return 0.0
    return multiset_intersection(a, b) / min(len(a), len(b))


def hamming(a: str, b: str) -> float:
    """Positional matches over max(la, lb): the length difference counts as
    mismatches."""
    if not a and not b:
        return 1.0
    matches = sum(1 for x, y in zip(a, b) if x == y)
    return matches / max(len(a), len(b))


def lcs_length(a: str, b: str) -> int:
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return 0
    prev = [0] * (n + 1)
    for i in range(1, m + 1):
        cur = [0] * (n + 1)
        ai = a[i - 1]
        for j in range(1, n + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else max(prev[j], cur[j - 1])
        prev = cur
    return prev[n]


def lcs_seq(a: str, b: str) -> float:
    """Longest-common-subsequence similarity: lcs / max(la, lb)."""
    if not a and not b:
        return 1.0
    if not a or not b:
        return 0.0
    return lcs_length(a, b) / max(len(a), len(b))


def indel(a: str, b: str) -> float:
    """Normalized indel similarity: 2 * lcs / (la + lb)."""
    if not a and not b:
        return 1.0
    if not a or not b:
        return 0.0
    return 2.0 * lcs_length(a, b) / (len(a) + len(b))


def osa_distance(a: str, b: str) -> int:
    """OSA (restricted Damerau-Levenshtein) distance: unit-cost edits plus
    adjacent transpositions, no substring edited twice (3-row DP)."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev2 = [0] * (lb + 1)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        ai = a[i - 1]
        for j in range(1, lb + 1):
            cost = 0 if ai == b[j - 1] else 1
            d = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if i > 1 and j > 1 and ai == b[j - 2] and a[i - 2] == b[j - 1]:
                d = min(d, prev2[j - 2] + 1)
            cur[j] = d
        prev2, prev = prev, cur
    return prev[lb]


def osa(a: str, b: str) -> float:
    """OSA similarity 1 - osa_distance / max(la, lb), with levenshtein's
    empty and equal conventions."""
    if (not a and not b) or a == b:
        return 1.0
    return 1.0 - (osa_distance(a, b) / max(len(a), len(b)))


# digit class per letter A..Z (spec in ops/phonetic.py)
_SOUNDEX_DIGITS = "01230120022455012623010202"


def soundex_code(s: str) -> str:
    """American Soundex code with the H/W rule: "Robert" -> "R163", "Lee" ->
    "L000"; chars outside [A-Za-z] are skipped and a string with no letter
    codes to ""."""
    first = ""
    prev = 0
    digits: list = []
    for ch in s:
        c = ord(ch)
        if 65 <= c <= 90:
            u = c
        elif 97 <= c <= 122:
            u = c - 32
        else:
            continue
        d = int(_SOUNDEX_DIGITS[u - 65])
        if not first:
            first = chr(u)
            prev = d
            continue
        if d != 0 and d != prev and len(digits) < 3:
            digits.append(d)
        if u != 72 and u != 87:  # H and W are transparent to "previous"
            prev = d
    if not first:
        return ""
    return first + "".join(str(d) for d in digits) + "0" * (3 - len(digits))


def soundex(a: str, b: str) -> float:
    """1.0 iff the soundex codes match (two letterless strings share the
    empty code); one side empty 0.0, both empty 1.0."""
    if not a and not b:
        return 1.0
    if not a or not b:
        return 0.0
    return 1.0 if soundex_code(a) == soundex_code(b) else 0.0


ORACLES = {
    "levenshtein": levenshtein,
    "jaro": jaro,
    "jaro_winkler": jaro_winkler,
    "jaccard": jaccard,
    "sorensen_dice": sorensen_dice,
    "jaccard_bigram": jaccard_bigram,
    "sorensen_dice_bigram": sorensen_dice_bigram,
    "cosine": cosine,
    "overlap": overlap,
    "hamming": hamming,
    "lcs_seq": lcs_seq,
    "indel": indel,
    "osa": osa,
    "soundex": soundex,
}
