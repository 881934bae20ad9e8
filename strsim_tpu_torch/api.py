"""Public API (array mode): the fourteen measure functions and batch entry
points.

Mirrors `strsim_tpu/api.py` for array-like columns (lists, numpy arrays,
anything with to_list): each function returns a float64 numpy array with NaN
at null rows. A plain Python str argument is a broadcast literal, as is
`lit(...)`. The polars expression layer is not part of this package yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from strsim_tpu_torch.config import StrsimConfig
from strsim_tpu_torch.models.measures import resolve_measures
from strsim_tpu_torch.models.pipeline import compute_scores


class Literal:
    """A string literal to broadcast against a column."""

    def __init__(self, value: Optional[str]):
        self.value = value


def lit(value: Optional[str]) -> Literal:
    return Literal(value)


def _as_column(x):
    if isinstance(x, Literal):
        return [x.value]
    if isinstance(x, str):
        return [x]  # a bare str is a broadcast literal
    if x is None:
        raise ValueError("cannot broadcast a null literal")
    return x


def compute_with_validity(
    measure: str, a, b, config: Optional[StrsimConfig] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """(values f64, validity bool) for one measure over two columns."""
    (m,) = resolve_measures(measure)
    return compute_scores(_as_column(a), _as_column(b), (m,), config=config)[m]


def compute(measure: str, a, b, config: Optional[StrsimConfig] = None) -> np.ndarray:
    """Scores for one measure; NaN marks null rows."""
    values, _ = compute_with_validity(measure, a, b, config)
    return values


def compute_many(
    measures: Sequence[str], a, b, config: Optional[StrsimConfig] = None
) -> Dict[str, np.ndarray]:
    """Scores for several measures in one pass: one encode, and each shared
    stat computed once."""
    res = compute_scores(_as_column(a), _as_column(b), resolve_measures(measures), config=config)
    return {m: v for m, (v, _) in res.items()}


def _measure_fn(measure: str):
    def fn(expr, other, *, config: Optional[StrsimConfig] = None):
        return compute(measure, expr, other, config=config)

    fn.__name__ = measure
    fn.__qualname__ = measure
    fn.__doc__ = (
        f"{measure} similarity in [0.0, 1.0] over two string columns: a float64\n"
        "numpy array with NaN at null rows. A str or lit(...) side broadcasts."
    )
    return fn


levenshtein = _measure_fn("levenshtein")
jaro = _measure_fn("jaro")
jaro_winkler = _measure_fn("jaro_winkler")
jaccard = _measure_fn("jaccard")
sorensen_dice = _measure_fn("sorensen_dice")

# extension measures, not in the reference (strsim_tpu/api.py)
jaccard_bigram = _measure_fn("jaccard_bigram")
sorensen_dice_bigram = _measure_fn("sorensen_dice_bigram")
cosine = _measure_fn("cosine")
overlap = _measure_fn("overlap")
hamming = _measure_fn("hamming")
lcs_seq = _measure_fn("lcs_seq")
indel = _measure_fn("indel")
osa = _measure_fn("osa")
soundex = _measure_fn("soundex")
