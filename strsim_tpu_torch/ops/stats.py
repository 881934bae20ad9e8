"""Integer sufficient statistics for the fourteen measures, and the router
that picks a kernel for each (the counterpart of `strsim_tpu/ops/stats.py`
with `strsim_tpu/models/pipeline.py:_impls_for` as it picks on a TPU).

Statistics per measure:
  levenshtein   -> edit distance lev_d                 (strsim.rs:146-159)
  jaro          -> match count jaro_m, raw transpositions jaro_t (:200-237)
  jaro_winkler  -> jaro_m, jaro_t, prefix (shared prefix <= 4)  (:261-266)
  jaccard/dice  -> multiset intersection inter          (:297-306)
and for the nine extensions (not in the reference):
  jaccard_bigram, sorensen_dice_bigram -> bigram intersection inter2, and
                  the row-equality eq (length-1 equal pairs have no bigrams)
  cosine, overlap -> inter
  hamming       -> positional matches ham_m
  lcs_seq, indel -> LCS length lcs_len
  osa           -> OSA distance osa_d
  soundex       -> soundex code equality sdx_eq

Tiles are [B, L] codepoints padded with PAD_A = -1 / PAD_B = -2, which never
equal each other or a real char, so equality needs no masks. `stat_routes`
keys on bucket width, tile dtype and the six per-family overrides
(`config.StrsimConfig.levenshtein_impl` ... `lcs_impl`); each wrapper keys on
the tile's device (CUDA kernel on CUDA tiles, its plain torch version on CPU
tiles). `resolve_impls` turns "auto" into what
strsim_tpu/models/pipeline.py:_impls_for picks on a TPU; the router then
follows strsim_tpu/ops/stats.py:compute_stats, with each Pallas kernel
replaced by its CUDA counterpart and each XLA form by plain torch. In order:

  K5 lev_jaro_fused  lev_d and jaro_m needed, levenshtein "pallas_scan", jaro
                     one of "pallas_scan*" ("pallas_scan" on int8 tiles
                     only), widths <= 64: lev_d, jaro_m, jaro_t, prefix and
                     each of inter, osa_d, lcs_len needed whose family is
                     "pallas_scan", from one equality build (:326-374)
  K6 dp_fused        at least two of {lev_d not from K5, osa_d, lcs_len}
                     whose families are "pallas_scan", or lcs_len alone,
                     widths <= 512 (:380-417)
  K1 levenshtein_myers   lev_d under "pallas_scan", widths <= 512
  K10 levenshtein_wavefront  lev_d under "pallas", widths <= 512
  K2 jaro_scan       jaro_m, jaro_t and prefix under every jaro value but
                     "pallas", widths <= 512, int8 and int32 (the JAX
                     engine's XLA bitmask and scan forms included: K2 is
                     exact for every codepoint, where the JAX Pallas
                     kernel's slot packing has a codepoint contract; the
                     JAX engine computes the prefix beside it in XLA, the
                     port in the same launch)
  K9 jaro_flags      jaro_m, jaro_t under "pallas", widths <= 512
  K3 multiset_rank   inter under "pallas_scan", widths <= 64; K4
                     multiset_hist under "pallas_hist", int8, widths <= 512
  K7 osa_scan        osa_d under "pallas_scan", widths <= 512
  K8 bigram          inter2 with ham_m and eq under "pallas_scan", widths
                     <= 64
  plain              prefix, ham_m, eq and sdx_eq when no kernel carries
                     them, every stat whose family takes an XLA form, and
                     every stat past its kernel's bounds (extend buckets >
                     511, wide int32 multiset, bigrams > 64), on whatever
                     device the tiles are on.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from strsim_tpu_torch.ops import (
    bigram_cuda,
    dp_fused_cuda,
    jaro_cuda,
    jaro_flags_cuda,
    lcs,
    lev_jaro_cuda,
    levenshtein_cuda,
    levenshtein_wavefront_cuda,
    multiset_cuda,
    osa_cuda,
    phonetic,
)

# jaro lists "prefix" too (its finalizer ignores it) so that jaro and
# jaro_winkler share one stat set.
STAT_FIELDS = {
    "levenshtein": ("lev_d",),
    "jaro": ("jaro_m", "jaro_t", "prefix"),
    "jaro_winkler": ("jaro_m", "jaro_t", "prefix"),
    "jaccard": ("inter",),
    "sorensen_dice": ("inter",),
    "jaccard_bigram": ("inter2", "eq"),
    "sorensen_dice_bigram": ("inter2", "eq"),
    "cosine": ("inter",),
    "overlap": ("inter",),
    "hamming": ("ham_m",),
    "lcs_seq": ("lcs_len",),
    "indel": ("lcs_len",),
    "osa": ("osa_d",),
    "soundex": ("sdx_eq",),
}


def shared_prefix_length(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Common prefix length capped at 4 chars (strsim.rs:261-266): the sum of
    the running AND of the first min(L, 4) compares. Pads differ between
    sides, so positions past either length compare unequal."""
    k = min(a.shape[1], 4)
    return (a[:, :k] == b[:, :k]).cummin(1).values.sum(1, dtype=torch.int32)


def row_equal(a, b, len_a, len_b) -> torch.Tensor:
    """1 where the rows are identical strings (pads differ per side, so
    positions past either length never compare equal)."""
    eq_cnt = (a == b).sum(1)
    return ((len_a == len_b) & (eq_cnt == len_a)).to(torch.int32)


_JARO_PACKED = ("pallas_scan", "pallas_scan_h", "pallas_scan_f")  # K5's jaro values


def resolve_impls(width: int, dtype: torch.dtype,
                  impls: Optional[Mapping[str, str]] = None) -> Dict[str, str]:
    """{family: kernel} for a bucket: each override in `impls` (a family
    left out is "auto"; the values are StrsimConfig's, checked there) as
    given, and "auto" as strsim_tpu/models/pipeline.py:_impls_for resolves
    it on a TPU (:53-181). On int32 tiles that is "pallas_scan_f" at widths
    <= 64, the value that keeps K5, where the JAX engine picks its slot
    packing from the bucket's largest codepoint; every jaro value but
    "pallas" reaches K2 here."""
    narrow = dtype == torch.int8
    auto = {
        "levenshtein": "pallas_scan" if levenshtein_cuda.supports_width(width) else "myers",
        "jaro": ("bitmask" if not jaro_cuda.supports_width(width)
                 else "pallas_scan" if narrow
                 else "pallas_scan_f" if lev_jaro_cuda.supports_width(width) else "bitmask"),
        "multiset": ("pallas_scan" if width <= multiset_cuda.RANK_MAX_WIDTH
                     else "pallas_hist" if narrow and width <= multiset_cuda.HIST_MAX_WIDTH
                     else "chunked"),
        "osa": "pallas_scan" if osa_cuda.supports_width(width) else "myers",
        "bigram": "pallas_scan" if bigram_cuda.supports_width(width) else "xla",
        "lcs": "pallas_scan" if dp_fused_cuda.supports_width(width) else "xla",
    }
    return {**auto, **{f: v for f, v in (impls or {}).items() if v != "auto"}}


def multiset_route(width: int, dtype: torch.dtype, impl: str) -> str:
    """Which multiset form a bucket takes under the resolved multiset value
    `impl`: "multiset_rank" (K3), "multiset_hist" (K4) or "plain" (the
    occurrence-rank torch version, the counterpart of the JAX engine's XLA
    forms "chunked", "xla" and "table")."""
    if impl == "pallas_scan" and width <= multiset_cuda.RANK_MAX_WIDTH:
        return "multiset_rank"
    if impl == "pallas_hist" and dtype == torch.int8 and width <= multiset_cuda.HIST_MAX_WIDTH:
        return "multiset_hist"
    return "plain"


def stat_routes(measures: Tuple[str, ...], width: int, dtype: torch.dtype,
                impls: Optional[Mapping[str, str]] = None) -> Dict[str, str]:
    """{stat: route} for every stat that `measures` need on a bucket of this
    width and tile dtype under the per-family overrides `impls` (see
    `resolve_impls`). A route is a kernel's launch-count name (see the
    module docstring) or "plain"."""
    impl = resolve_impls(width, dtype, impls)
    need = {f for m in measures for f in STAT_FIELDS[m]}
    scan = {f: f in need and impl[family] == "pallas_scan"
            for f, family in (("lev_d", "levenshtein"), ("inter", "multiset"),
                              ("osa_d", "osa"), ("lcs_len", "lcs"), ("inter2", "bigram"))}
    routes: Dict[str, str] = {}
    if (scan["lev_d"] and "jaro_m" in need and impl["jaro"] in _JARO_PACKED
            and lev_jaro_cuda.supports_width(width)
            and (impl["jaro"] != "pallas_scan" or dtype == torch.int8)):
        flags = (scan["inter"], scan["osa_d"], scan["lcs_len"])
        routes.update((f, "lev_jaro_fused") for f in lev_jaro_cuda.fields(*flags))
    dp = [f for f in ("lev_d", "osa_d", "lcs_len") if scan[f] and f not in routes]
    if (len(dp) >= 2 or dp == ["lcs_len"]) and dp_fused_cuda.supports_width(width):
        routes.update((f, "dp_fused") for f in dp)
    if scan["inter2"] and bigram_cuda.supports_width(width):
        routes.update((f, "bigram") for f in ("inter2", "ham_m", "eq") if f in need)
    lev, jaro = "plain", "plain"
    if scan["lev_d"] and levenshtein_cuda.supports_width(width):
        lev = "levenshtein_myers"
    elif impl["levenshtein"] == "pallas" and levenshtein_wavefront_cuda.supports_width(width):
        lev = "levenshtein_wavefront"
    if impl["jaro"] == "pallas" and jaro_flags_cuda.supports_width(width):
        jaro = "jaro_flags"
    elif impl["jaro"] != "pallas" and jaro_cuda.supports_width(width):
        jaro = "jaro_scan"
    single = {
        "lev_d": lev,
        "jaro_m": jaro,
        "prefix": "jaro_scan" if jaro == "jaro_scan" else "plain",
        "inter": multiset_route(width, dtype, impl["multiset"]),
        "osa_d": "osa_scan" if scan["osa_d"] and osa_cuda.supports_width(width) else "plain",
    }
    single["jaro_t"] = single["jaro_m"]
    for f in sorted(need - set(routes)):
        routes[f] = single.get(f, "plain")
    return routes


# plain torch version of each stat: stat -> (the stats it returns, function)
_PLAIN = {
    "lev_d": (("lev_d",), levenshtein_cuda.myers_plain),
    "jaro_m": (("jaro_m", "jaro_t"), jaro_cuda.jaro_plain),
    "jaro_t": (("jaro_m", "jaro_t"), jaro_cuda.jaro_plain),
    "prefix": (("prefix",), lambda a, b, la, lb: shared_prefix_length(a, b)),
    "inter": (("inter",), multiset_cuda.rank_plain),
    "inter2": (("inter2",), lambda a, b, la, lb: bigram_cuda.bigram_plain(a, b, la, lb)[0]),
    "ham_m": (("ham_m",), lambda a, b, la, lb: bigram_cuda.ham_plain(a, b)),
    "eq": (("eq",), row_equal),
    "sdx_eq": (("sdx_eq",), phonetic.soundex_equal),
    "osa_d": (("osa_d",), osa_cuda.osa_plain),
    "lcs_len": (("lcs_len",), lcs.lcs_plain),
}

# kernels that return a fixed set of stats: route -> (stats, wrapper)
_KERNELS = {
    "levenshtein_myers": (("lev_d",), levenshtein_cuda.levenshtein_distance),
    "levenshtein_wavefront": (("lev_d",), levenshtein_wavefront_cuda.levenshtein_distance),
    "jaro_flags": (("jaro_m", "jaro_t"), jaro_flags_cuda.jaro_match_stats),
    "multiset_rank": (("inter",), multiset_cuda.multiset_intersection_rank),
    "multiset_hist": (("inter",), multiset_cuda.multiset_intersection_hist),
    "osa_scan": (("osa_d",), osa_cuda.osa_distance),
    "bigram": (("inter2", "ham_m", "eq"), bigram_cuda.bigram_stats),
}


def compute_stats(
    a: torch.Tensor,
    b: torch.Tensor,
    len_a: torch.Tensor,
    len_b: torch.Tensor,
    measures: Tuple[str, ...],
    impls: Optional[Mapping[str, str]] = None,
) -> Dict[str, torch.Tensor]:
    """The union of the stats `measures` need, each computed once on the
    route `stat_routes` gives it under the overrides `impls`, as [B] int32
    tensors on the tiles' device."""
    routes = stat_routes(measures, a.shape[1], a.dtype, impls)
    args = (a, b, len_a, len_b)
    out: Dict[str, torch.Tensor] = {}
    for stat, route in routes.items():
        if stat in out:  # an earlier call on its route returned it
            continue
        mine = {f for f, r in routes.items() if r == route}
        if route == "lev_jaro_fused":
            flags = dict(with_inter="inter" in mine, with_osa="osa_d" in mine,
                         with_lcs="lcs_len" in mine)
            names, res = lev_jaro_cuda.fields(**flags), lev_jaro_cuda.lev_jaro_stats(*args, **flags)
        elif route == "jaro_scan":
            with_prefix = "prefix" in mine
            names = ("jaro_m", "jaro_t", "prefix") if with_prefix else ("jaro_m", "jaro_t")
            res = jaro_cuda.jaro_match_stats(*args, with_prefix=with_prefix)
        elif route == "dp_fused":
            flags = ("lev_d" in mine, "osa_d" in mine, "lcs_len" in mine)
            names, res = dp_fused_cuda.fields(*flags), dp_fused_cuda.dp_fused_stats(*args, *flags)
        else:
            names, fn = _PLAIN[stat] if route == "plain" else _KERNELS[route]
            res = fn(*args)
        out.update(zip(names, res if isinstance(res, tuple) else (res,)))
    return {f: out[f] for f in routes}
