"""Measure registry: each measure declares the integer statistics it needs on
the device and the host finalizer that turns them into exact f64 scores
(the reference's SimilarityFunctionType dispatch, strsim.rs:9-19)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from strsim_tpu_torch.ops import finalize as _finalize
from strsim_tpu_torch.ops import oracle as _oracle
from strsim_tpu_torch.ops.stats import STAT_FIELDS


@dataclasses.dataclass(frozen=True)
class Measure:
    name: str
    stat_fields: Tuple[str, ...]
    finalizer: Callable[[Dict[str, np.ndarray], np.ndarray, np.ndarray], np.ndarray]
    oracle: Callable[[str, str], float]


MEASURES: Dict[str, Measure] = {
    name: Measure(
        name=name,
        stat_fields=STAT_FIELDS[name],
        finalizer=_finalize.FINALIZERS[name],
        oracle=_oracle.ORACLES[name],
    )
    for name in (
        # the reference's five
        "levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice",
        # extensions, not in the reference (strsim_tpu/models/measures.py)
        "jaccard_bigram", "sorensen_dice_bigram", "cosine", "overlap", "hamming",
        "lcs_seq", "indel", "osa", "soundex",
    )
}


def resolve_measures(measures) -> Tuple[str, ...]:
    if isinstance(measures, str):
        measures = (measures,)
    out = []
    for m in measures:
        if m not in MEASURES:
            raise KeyError(f"unknown measure {m!r}; available: {', '.join(MEASURES)}")
        out.append(m)
    return tuple(out)
