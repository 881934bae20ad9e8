"""Least integer operations of each statistic for rows of lengths la, lb
(int64 arrays), frozen from `strsim_tpu_torch/ops/roofline.py:work_ops` as
of the benchmark's first version and keyed by statistic, never by kernel.

Bit-parallel recurrences over 32-bit words: Myers 17 word operations a word
and step, Hyyro OSA 21, Allison-Dix LCS 4, the jaro greedy step 5 a word of
its window; each counted in the orientation with fewer word-steps. The
equality word a step reads comes from a per-row table built from the
pattern's chars: one read a word-step for the most demanding recurrence
(recurrences in one orientation share it) and one build of min(la, lb)
chars a row. Multisets by histogram, 2 operations a char."""
from __future__ import annotations

import numpy as np

MYERS_OPS, OSA_OPS, LCS_OPS, JARO_OPS = 17, 21, 4, 5


def words(n):
    return -(-n // 32)


def word_steps(la, lb):
    """Word-steps of a bit-parallel DP: pattern words times text chars, in
    the cheaper orientation."""
    return np.minimum(words(la) * lb, words(lb) * la)


def jaro_window(la, lb):
    """(a-positions the greedy scan visits, words of b in each window)."""
    bound = np.maximum(la, lb) // 2 - 1
    steps = np.clip(np.minimum(la, lb + bound), 0, None)
    return steps, words(np.clip(np.minimum(2 * bound + 1, lb), 0, None))


def jaro_word_steps(la, lb):
    steps, win = jaro_window(la, lb)
    return win * steps


def myers(la, lb):
    return MYERS_OPS * word_steps(la, lb)


def osa(la, lb):
    return OSA_OPS * word_steps(la, lb)


def lcs(la, lb):
    return LCS_OPS * word_steps(la, lb)


def jaro(la, lb):
    return JARO_OPS * jaro_word_steps(la, lb)


def prefix(la, lb):
    return np.minimum(np.minimum(la, lb), 4)


def char_histograms(la, lb):
    return 2 * (la + lb)


def bigram_histograms(la, lb):
    return 2 * (np.maximum(la - 1, 0) + np.maximum(lb - 1, 0))


def positions(la, lb):
    return np.minimum(la, lb)


def table_build(la, lb):
    return np.minimum(la, lb)
