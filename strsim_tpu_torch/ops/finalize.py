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


FINALIZERS = {
    "levenshtein": finalize_levenshtein,
    "jaro": finalize_jaro,
    "jaro_winkler": finalize_jaro_winkler,
    "jaccard": finalize_jaccard,
    "sorensen_dice": finalize_sorensen_dice,
}


def finalize(measure: str, stats: Dict[str, np.ndarray], la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    return FINALIZERS[measure](stats, la, lb)
