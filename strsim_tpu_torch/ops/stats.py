"""Integer sufficient statistics for the five measures, and the router that
picks a kernel for each (the counterpart of `strsim_tpu/ops/stats.py` with
`strsim_tpu/models/pipeline.py:_impls_for`).

Statistics per measure:
  levenshtein   -> edit distance lev_d                 (strsim.rs:146-159)
  jaro          -> match count jaro_m, raw transpositions jaro_t (:200-237)
  jaro_winkler  -> jaro_m, jaro_t, prefix (shared prefix <= 4)  (:261-266)
  jaccard/dice  -> multiset intersection inter          (:297-306)

Tiles are [B, L] codepoints padded with PAD_A = -1 / PAD_B = -2, which never
equal each other or a real char, so equality needs no masks. The router keys
on bucket width and tile dtype; each wrapper keys on the tile's device (CUDA
kernel on CUDA tiles, its plain torch version on CPU tiles):

  lev_d + jaro_m  K5 fused kernel when both are needed at widths <= 64:
                  lev_d, jaro_m, jaro_t, prefix and (if needed) inter from
                  one equality build (strsim_tpu/ops/stats.py:326-374)
  lev_d           K1 Myers kernel, widths <= 512
  jaro_m, jaro_t  K2 jaro scan kernel, widths <= 512, int8 and int32
  inter           K3 occurrence-rank kernel, widths <= 64;
                  K4 histogram kernel, wider int8 tiles up to 512
  prefix          plain tensor code everywhere but in K5

Beyond those bounds (extend buckets > 511, wide int32 multiset) the plain
torch versions run on whatever device the tiles are on, where the JAX engine
also leaves its TPU kernels for its XLA ones.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from strsim_tpu_torch.ops import jaro_cuda, lev_jaro_cuda, levenshtein_cuda, multiset_cuda

# jaro lists "prefix" too (its finalizer ignores it) so that jaro and
# jaro_winkler share one stat set.
STAT_FIELDS = {
    "levenshtein": ("lev_d",),
    "jaro": ("jaro_m", "jaro_t", "prefix"),
    "jaro_winkler": ("jaro_m", "jaro_t", "prefix"),
    "jaccard": ("inter",),
    "sorensen_dice": ("inter",),
}


def shared_prefix_length(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Common prefix length capped at 4 chars (strsim.rs:261-266). Pads differ
    between sides, so positions past either length compare unequal."""
    k = min(a.shape[1], 4)
    eq = (a[:, :k] == b[:, :k]).to(torch.int32)
    return torch.cumprod(eq, dim=1).sum(1).to(torch.int32)


def row_equal(a, b, len_a, len_b) -> torch.Tensor:
    """1 where the rows are identical strings (pads differ per side, so
    positions past either length never compare equal)."""
    eq_cnt = (a == b).sum(1)
    return ((len_a == len_b) & (eq_cnt == len_a)).to(torch.int32)


def multiset_route(width: int, dtype: torch.dtype) -> str:
    """Which multiset form a bucket takes: "rank" (K3), "hist" (K4) or
    "plain" (the occurrence-rank torch version, no kernel)."""
    if width <= multiset_cuda.RANK_MAX_WIDTH:
        return "rank"
    if dtype == torch.int8 and width <= multiset_cuda.HIST_MAX_WIDTH:
        return "hist"
    return "plain"


def compute_stats(
    a: torch.Tensor,
    b: torch.Tensor,
    len_a: torch.Tensor,
    len_b: torch.Tensor,
    measures: Tuple[str, ...],
) -> Dict[str, torch.Tensor]:
    """The union of the stats `measures` need, each computed once, as [B]
    int32 tensors on the tiles' device."""
    need = {f for m in measures for f in STAT_FIELDS[m]}
    width = a.shape[1]
    out: Dict[str, torch.Tensor] = {}
    if "lev_d" in need and "jaro_m" in need and lev_jaro_cuda.supports_width(width):
        with_inter = "inter" in need
        res = lev_jaro_cuda.lev_jaro_stats(a, b, len_a, len_b, with_inter)
        out.update(zip(lev_jaro_cuda.fields(with_inter), res))
    if "lev_d" in need and "lev_d" not in out:
        if levenshtein_cuda.supports_width(width):
            out["lev_d"] = levenshtein_cuda.levenshtein_distance(a, b, len_a, len_b)
        else:
            out["lev_d"] = levenshtein_cuda.myers_plain(a, b, len_a, len_b)
    if "jaro_m" in need and "jaro_m" not in out:
        if jaro_cuda.supports_width(width):
            out["jaro_m"], out["jaro_t"] = jaro_cuda.jaro_match_stats(a, b, len_a, len_b)
        else:
            out["jaro_m"], out["jaro_t"] = jaro_cuda.jaro_plain(a, b, len_a, len_b)
    if "prefix" in need and "prefix" not in out:
        out["prefix"] = shared_prefix_length(a, b)
    if "inter" in need and "inter" not in out:
        route = multiset_route(width, a.dtype)
        if route == "rank":
            out["inter"] = multiset_cuda.multiset_intersection_rank(a, b, len_a, len_b)
        elif route == "hist":
            out["inter"] = multiset_cuda.multiset_intersection_hist(a, b, len_a, len_b)
        else:
            out["inter"] = multiset_cuda.rank_plain(a, b, len_a, len_b)
    return out
