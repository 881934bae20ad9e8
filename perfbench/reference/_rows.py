"""Plain NumPy reference of the fourteen measures: the row conventions and
the integer statistics, vectorised over rows, that each measure's module
(`reference/<measure>.py`) finishes into a score.

Written from the reference semantics (polars-strsim's strsim.rs, as
SURVEY.md cites it) and from the extensions' definitions. It imports nothing
of strsim_tpu_torch and recomputes everything from the strings it is given:

  * chars are Unicode scalar values (strsim.rs:133,138);
  * a null side gives NaN; both empty or equal gives 1.0 and exactly one
    side empty 0.0, for every measure (strsim.rs:128,182,288,324);
  * the other rows go to the measure's `work(A, B, la, lb, dtype)` in chunks
    of rows sorted by length: A, B are [R, W] int32 codepoints padded with
    -1 (a) and -2 (b), which equal neither each other nor a char; la, lb
    int64 lengths. The dynamic programs run row by row of the DP table over
    all R rows at once, so a chunk costs max(la) steps of [R, max(lb)]
    array operations.

Scores are finished in `dtype`: float64 gives the reference's values bit for
bit (numpy evaluates the formulas in the reference's order, and int / int is
the correctly rounded quotient in both); float32 is the control's lower
precision.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

PAD_A, PAD_B = -1, -2
CHUNK_ROWS = 256
MIN_WIDTH = 4  # the prefix reads 4 columns


def f(x, dtype):
    """Integer array x as `dtype`."""
    return np.asarray(x).astype(dtype)


def codes(strings: Sequence[str], pad: int) -> np.ndarray:
    """[R, W] int32 codepoints, padded with `pad`, W the longest string (at
    least MIN_WIDTH)."""
    width = max([MIN_WIDTH] + [len(s) for s in strings])
    out = np.full((len(strings), width), pad, dtype=np.int32)
    for i, s in enumerate(strings):
        if s:
            out[i, : len(s)] = np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)
    return out


def scores(a: Sequence, b: Sequence, work: Callable, dtype=np.float64) -> np.ndarray:
    """float64 [n] scores of `work`'s measure over columns a, b of str |
    None, under the row conventions of the module docstring."""
    if len(a) != len(b):
        raise ValueError(f"columns of {len(a)} and {len(b)} rows")
    out = np.full(len(a), np.nan, dtype=np.float64)
    rest = []
    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            continue
        if x == y:
            out[i] = 1.0
        elif not x or not y:
            out[i] = 0.0
        else:
            rest.append(i)
    rest = np.asarray(rest, dtype=np.int64)
    longest = np.array([max(len(a[i]), len(b[i])) for i in rest], dtype=np.int64)
    rest = rest[np.argsort(longest, kind="stable")]
    for start in range(0, rest.size, CHUNK_ROWS):
        rows = rest[start : start + CHUNK_ROWS]
        sa, sb = [a[i] for i in rows], [b[i] for i in rows]
        la = np.array([len(s) for s in sa], dtype=np.int64)
        lb = np.array([len(s) for s in sb], dtype=np.int64)
        out[rows] = work(codes(sa, PAD_A), codes(sb, PAD_B), la, lb, dtype)
    return out


def _take_at(out, cur, done, lb):
    rows = np.nonzero(done)[0]
    out[rows] = cur[rows, lb[rows]]


def levenshtein_distance(A, B, la, lb) -> np.ndarray:
    """Unit-cost edit distance. Row i of the table from row i - 1: t[j] =
    min(prev[j - 1] + cost, prev[j] + 1), then the insertion chain cur[j] =
    min over k <= j of t[k] + (j - k), a running minimum of t[k] - k."""
    R, La = A.shape
    j = np.arange(B.shape[1] + 1, dtype=np.int64)
    prev = np.broadcast_to(j, (R, j.size)).copy()
    out = lb.copy()
    t = np.empty_like(prev)
    for i in range(1, La + 1):
        cost = A[:, i - 1 : i] != B
        t[:, 0] = i
        np.minimum(prev[:, :-1] + cost, prev[:, 1:] + 1, out=t[:, 1:])
        cur = np.minimum.accumulate(t - j, axis=1) + j
        _take_at(out, cur, la == i, lb)
        prev = cur
    return out


def osa_distance(A, B, la, lb) -> np.ndarray:
    """Optimal string alignment distance: levenshtein's table plus the
    adjacent transposition prev2[j - 2] + 1 where a[i-1] == b[j-2] and
    a[i-2] == b[j-1]."""
    R, La = A.shape
    j = np.arange(B.shape[1] + 1, dtype=np.int64)
    prev2 = np.zeros((R, j.size), dtype=np.int64)
    prev = np.broadcast_to(j, (R, j.size)).copy()
    out = lb.copy()
    t = np.empty_like(prev)
    for i in range(1, La + 1):
        ai = A[:, i - 1 : i]
        t[:, 0] = i
        np.minimum(prev[:, :-1] + (ai != B), prev[:, 1:] + 1, out=t[:, 1:])
        if i > 1 and B.shape[1] > 1:
            swap = (ai == B[:, :-1]) & (A[:, i - 2 : i - 1] == B[:, 1:])
            t[:, 2:] = np.where(swap, np.minimum(t[:, 2:], prev2[:, :-2] + 1), t[:, 2:])
        cur = np.minimum.accumulate(t - j, axis=1) + j
        _take_at(out, cur, la == i, lb)
        prev2, prev = prev, cur
    return out


def lcs_length(A, B, la, lb) -> np.ndarray:
    """Longest common subsequence: cur[j] = the running maximum of
    max(prev[j], prev[j - 1] + 1 where a[i-1] == b[j-1])."""
    R, La = A.shape
    prev = np.zeros((R, B.shape[1] + 1), dtype=np.int64)
    out = np.zeros(R, dtype=np.int64)
    x = np.zeros_like(prev)
    for i in range(1, La + 1):
        eq = A[:, i - 1 : i] == B
        np.maximum(prev[:, 1:], np.where(eq, prev[:, :-1] + 1, 0), out=x[:, 1:])
        cur = np.maximum.accumulate(x, axis=1)
        _take_at(out, cur, la == i, lb)
        prev = cur
    return out


def jaro_stats(A, B, la, lb):
    """(m, t_raw): the greedy windowed match of strsim.rs:200-237. a's chars
    in order, only the first min(la, lb + bound) of them, each take the first
    unflagged equal b char in [i - bound, i + bound] within [0, lb), bound =
    max(la, lb) // 2 - 1; t_raw counts the matched chars that differ when
    a's and b's matches are zipped in order."""
    R, La = A.shape
    Lb = B.shape[1]
    bound = np.maximum(la, lb) // 2 - 1
    stop = np.minimum(la, lb + bound)
    lo = np.maximum(0, np.arange(La)[None, :] - bound[:, None])
    hi = np.minimum(np.arange(La)[None, :] + bound[:, None], (lb - 1)[:, None])
    jj = np.arange(Lb)[None, :]
    fa = np.zeros((R, La), dtype=bool)
    fb = np.zeros((R, Lb), dtype=bool)
    m = np.zeros(R, dtype=np.int64)
    for i in range(int(stop.max(initial=0))):
        cand = (A[:, i : i + 1] == B) & ~fb & (jj >= lo[:, i : i + 1]) & (jj <= hi[:, i : i + 1])
        cand &= (i < stop)[:, None]
        rows = np.nonzero(cand.any(axis=1))[0]
        first = cand[rows].argmax(axis=1)
        fb[rows, first] = True
        fa[rows, i] = True
        m[rows] += 1
    ca = np.take_along_axis(A, np.argsort(~fa, axis=1, kind="stable"), axis=1)
    cb = np.take_along_axis(B, np.argsort(~fb, axis=1, kind="stable"), axis=1)
    k = min(La, Lb)
    t = ((ca[:, :k] != cb[:, :k]) & (np.arange(k)[None, :] < m[:, None])).sum(axis=1)
    return m, t


def jaro_score(A, B, la, lb, dtype) -> np.ndarray:
    """(m / la + m / lb + (m - t // 2) / m) / 3 (strsim.rs:239-243); 0.0
    with no match and for two single unequal chars."""
    m, t = jaro_stats(A, B, la, lb)
    with np.errstate(divide="ignore", invalid="ignore"):
        js = (f(m, dtype) / f(la, dtype) + f(m, dtype) / f(lb, dtype)
              + f(m - t // 2, dtype) / f(m, dtype)) / dtype(3.0)
    return np.where((m == 0) | ((la == 1) & (lb == 1)), dtype(0.0), js)


def shared_prefix(A, B) -> np.ndarray:
    """Common prefix length capped at 4 (strsim.rs:261-266)."""
    eq = A[:, :4] == B[:, :4]
    return np.cumprod(eq, axis=1).sum(axis=1)


def _multiset_inter(keys_a, rows_a, keys_b, rows_b, bits, R) -> np.ndarray:
    """Per row, the sum over items of min(count in a, count in b)."""
    ua, ca = np.unique((rows_a << bits) | keys_a, return_counts=True)
    ub, cb = np.unique((rows_b << bits) | keys_b, return_counts=True)
    common, ia, ib = np.intersect1d(ua, ub, assume_unique=True, return_indices=True)
    mins = np.minimum(ca[ia], cb[ib])
    return np.bincount(common >> bits, weights=mins, minlength=R).astype(np.int64)


def _chars(X, lens):
    mask = np.arange(X.shape[1])[None, :] < lens[:, None]
    return X[mask].astype(np.int64), np.nonzero(mask)[0].astype(np.int64)


def char_inter(A, B, la, lb) -> np.ndarray:
    """Character-multiset intersection (strsim.rs:297-306)."""
    ka, ra = _chars(A, la)
    kb, rb = _chars(B, lb)
    return _multiset_inter(ka, ra, kb, rb, 21, A.shape[0])


def _bigrams(X, lens):
    if X.shape[1] < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    mask = np.arange(X.shape[1] - 1)[None, :] < (lens - 1)[:, None]
    keys = (X[:, :-1].astype(np.int64) << 21) | X[:, 1:].astype(np.int64)
    return keys[mask], np.nonzero(mask)[0].astype(np.int64)


def bigram_inter(A, B, la, lb) -> np.ndarray:
    """Bigram-multiset intersection of adjacent char pairs."""
    ka, ra = _bigrams(A, la)
    kb, rb = _bigrams(B, lb)
    return _multiset_inter(ka, ra, kb, rb, 42, A.shape[0])


def positional_matches(A, B) -> np.ndarray:
    """Positions where both strings hold the same char (pads never match)."""
    k = min(A.shape[1], B.shape[1])
    return (A[:, :k] == B[:, :k]).sum(axis=1)


# American Soundex digit classes of A..Z
_SOUNDEX = "01230120022455012623010202"


def soundex_code(s: str) -> str:
    """American Soundex with the H/W rule: the first letter, then up to three
    digits of the following letters, a digit dropped when it repeats the
    previous letter's (H and W do not separate two equal digits; vowels do),
    zeros after; chars outside A-Z/a-z skipped; "" when there is no letter."""
    first, prev, digits = "", 0, []
    for ch in s:
        c = ord(ch)
        if 97 <= c <= 122:
            c -= 32
        if not 65 <= c <= 90:
            continue
        d = int(_SOUNDEX[c - 65])
        if not first:
            first, prev = chr(c), d
            continue
        if d != 0 and d != prev and len(digits) < 3:
            digits.append(d)
        if chr(c) not in "HW":
            prev = d
    if not first:
        return ""
    return first + "".join(map(str, digits)) + "0" * (3 - len(digits))


def decode(X, lens):
    return ["".join(map(chr, X[r, : lens[r]])) for r in range(X.shape[0])]
