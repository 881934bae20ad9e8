"""Host finalization: integer statistics -> exact f64 scores.

Each formula reproduces the reference's f64 arithmetic in its evaluation
order (left to right, same associativity), so identical integer statistics
give bit-for-float identical scores. Copied op for op from
`strsim_tpu/ops/finalize.py`:

  levenshtein   1.0 - (d / max(la, lb))                  strsim.rs:160
  jaro          (m/la + m/lb + (m - t//2)/m) / 3.0       strsim.rs:241-242
  jaro_winkler  jaro + ((prefix * 0.1) * (1.0 - jaro))   strsim.rs:267
  jaccard       inter / (la + lb - inter)                strsim.rs:301-306
  sorensen_dice (2.0 * inter) / (la + lb)                strsim.rs:343

and for the nine extensions (not in the reference), as
`strsim_tpu/ops/finalize.py` has them:

  jaccard_bigram        inter2 / (na + nb - inter2)      na = max(la - 1, 0)
  sorensen_dice_bigram  (2.0 * inter2) / (na + nb)
  cosine                inter / sqrt(la * lb)
  overlap               inter / min(la, lb)
  hamming               ham_m / max(la, lb)
  lcs_seq               lcs / max(la, lb)
  indel                 (2.0 * lcs) / (la + lb)
  osa                   1.0 - (osa_d / max(la, lb))
  soundex               sdx_eq

The bigram measures score equal strings 1.0 from the `eq` stat, since
length-1 equal pairs have no bigrams.

Empty-string guards (strsim.rs:128-130, 182-186, 288-291, 324-327): both
empty -> 1.0 for every measure; one side empty -> 0.0, guarded explicitly so
the result does not depend on what a kernel returns on degenerate rows.

Inputs are numpy integer arrays; outputs are float64 arrays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _as_f64(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float64)


def finalize_levenshtein(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    any_empty = (la == 0) | (lb == 0)
    maxlen = np.maximum(la, lb)
    d = np.where(any_empty, maxlen, stats["lev_d"])
    safe_max = np.maximum(maxlen, 1)
    sim = 1.0 - (_as_f64(d) / _as_f64(safe_max))
    return np.where(both_empty, 1.0, sim)


def finalize_jaro(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    m = stats["jaro_m"].astype(np.int64)
    t = stats["jaro_t"].astype(np.int64)
    safe_m = np.maximum(m, 1)
    safe_la = np.maximum(la, 1).astype(np.int64)
    safe_lb = np.maximum(lb, 1).astype(np.int64)
    mf = _as_f64(m)
    sim = (mf / _as_f64(safe_la) + mf / _as_f64(safe_lb) + _as_f64(m - t // 2) / _as_f64(safe_m)) / 3.0
    sim = np.where(m == 0, 0.0, sim)
    return np.where(both_empty, 1.0, sim)


def finalize_jaro_winkler(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    js = finalize_jaro(stats, la, lb)
    prefix = _as_f64(stats["prefix"])
    boosted = js + ((prefix * 0.1) * (1.0 - js))
    return np.where(js > 0.7, boosted, js)


def finalize_jaccard(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    any_empty = (la == 0) | (lb == 0)
    inter = stats["inter"].astype(np.int64)
    den = la.astype(np.int64) + lb.astype(np.int64) - inter
    sim = _as_f64(inter) / _as_f64(np.maximum(den, 1))
    sim = np.where(any_empty, 0.0, sim)
    return np.where(both_empty, 1.0, sim)


def finalize_sorensen_dice(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    any_empty = (la == 0) | (lb == 0)
    inter = stats["inter"].astype(np.int64)
    den = la.astype(np.int64) + lb.astype(np.int64)
    sim = (2.0 * _as_f64(inter)) / _as_f64(np.maximum(den, 1))
    sim = np.where(any_empty, 0.0, sim)
    return np.where(both_empty, 1.0, sim)


def _patch_bigram_equal(sim: np.ndarray, stats: Dict[str, np.ndarray]) -> np.ndarray:
    """Equal strings score 1.0, whatever the pipeline's equal fast path did:
    length-1 equal pairs have no bigrams and would score 0.0."""
    eq = stats.get("eq")
    if eq is not None:
        sim = np.where(eq.astype(bool), 1.0, sim)
    return sim


def finalize_jaccard_bigram(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    na = np.maximum(la.astype(np.int64) - 1, 0)
    nb = np.maximum(lb.astype(np.int64) - 1, 0)
    inter = stats["inter2"].astype(np.int64)
    den = na + nb - inter
    sim = _as_f64(inter) / _as_f64(np.maximum(den, 1))
    sim = np.where((na == 0) | (nb == 0), 0.0, sim)
    return _patch_bigram_equal(sim, stats)


def finalize_sorensen_dice_bigram(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    na = np.maximum(la.astype(np.int64) - 1, 0)
    nb = np.maximum(lb.astype(np.int64) - 1, 0)
    inter = stats["inter2"].astype(np.int64)
    sim = (2.0 * _as_f64(inter)) / _as_f64(np.maximum(na + nb, 1))
    sim = np.where((na == 0) | (nb == 0), 0.0, sim)
    return _patch_bigram_equal(sim, stats)


def finalize_cosine(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    any_empty = (la == 0) | (lb == 0)
    inter = stats["inter"].astype(np.int64)
    den = np.sqrt(_as_f64(la.astype(np.int64) * lb.astype(np.int64)))
    sim = _as_f64(inter) / np.maximum(den, 1.0)
    sim = np.where(any_empty, 0.0, sim)
    return np.where(both_empty, 1.0, sim)


def finalize_overlap(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    any_empty = (la == 0) | (lb == 0)
    inter = stats["inter"].astype(np.int64)
    den = np.minimum(la, lb).astype(np.int64)
    sim = _as_f64(inter) / _as_f64(np.maximum(den, 1))
    sim = np.where(any_empty, 0.0, sim)
    return np.where(both_empty, 1.0, sim)


def finalize_hamming(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    matches = stats["ham_m"].astype(np.int64)
    den = np.maximum(np.maximum(la, lb), 1).astype(np.int64)
    sim = _as_f64(matches) / _as_f64(den)
    return np.where(both_empty, 1.0, sim)


def finalize_lcs_seq(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    any_empty = (la == 0) | (lb == 0)
    lcs = stats["lcs_len"].astype(np.int64)
    den = np.maximum(np.maximum(la, lb), 1).astype(np.int64)
    sim = _as_f64(lcs) / _as_f64(den)
    sim = np.where(any_empty, 0.0, sim)
    return np.where(both_empty, 1.0, sim)


def finalize_indel(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    any_empty = (la == 0) | (lb == 0)
    lcs = stats["lcs_len"].astype(np.int64)
    den = np.maximum(la.astype(np.int64) + lb.astype(np.int64), 1)
    sim = (2.0 * _as_f64(lcs)) / _as_f64(den)
    sim = np.where(any_empty, 0.0, sim)
    return np.where(both_empty, 1.0, sim)


def finalize_osa(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    any_empty = (la == 0) | (lb == 0)
    maxlen = np.maximum(la, lb)
    d = np.where(any_empty, maxlen, stats["osa_d"])
    safe_max = np.maximum(maxlen, 1)
    sim = 1.0 - (_as_f64(d) / _as_f64(safe_max))
    return np.where(both_empty, 1.0, sim)


def finalize_soundex(stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    both_empty = (la == 0) & (lb == 0)
    any_empty = (la == 0) | (lb == 0)
    sim = _as_f64(stats["sdx_eq"])
    sim = np.where(any_empty, 0.0, sim)
    return np.where(both_empty, 1.0, sim)


FINALIZERS = {
    "levenshtein": finalize_levenshtein,
    "jaro": finalize_jaro,
    "jaro_winkler": finalize_jaro_winkler,
    "jaccard": finalize_jaccard,
    "sorensen_dice": finalize_sorensen_dice,
    "jaccard_bigram": finalize_jaccard_bigram,
    "sorensen_dice_bigram": finalize_sorensen_dice_bigram,
    "cosine": finalize_cosine,
    "overlap": finalize_overlap,
    "hamming": finalize_hamming,
    "lcs_seq": finalize_lcs_seq,
    "indel": finalize_indel,
    "osa": finalize_osa,
    "soundex": finalize_soundex,
}


def finalize(measure: str, stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    return FINALIZERS[measure](stats, la, lb)
