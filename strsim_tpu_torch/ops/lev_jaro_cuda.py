"""Shared-equality fused stats for lev + jaro requests at widths <= 64.

`lev_jaro_stats` launches the hand-written CUDA kernel
(csrc/lev_jaro_fused.cu) on CUDA tiles and runs `lev_jaro_plain` on CPU
tiles. It is the counterpart of
`strsim_tpu/ops/lev_jaro_pallas.py:fused_stats_pallas`: one equality build a
row serves the Myers distance, the jaro greedy scan, the multiset count, the
4-capped prefix and the OSA and LCS recurrences, where the separate kernels
would each rebuild their share of it. `ops/stats.py:stat_routes` takes it
whenever lev_d and jaro_m are both needed at these widths, as the JAX engine
does, with inter, osa_d and lcs_len when the request needs them too.

Contract (both forms, every row): the stats of the separate kernels on the
same tiles: lev_d as `levenshtein_cuda.myers_plain`, (jaro_m, jaro_t) as
`jaro_cuda.jaro_plain`, prefix as `stats.shared_prefix_length` and, when
asked for, inter as `multiset_cuda.rank_plain`, osa_d as `osa_cuda.osa_plain`
and lcs_len as `lcs.lcs_plain`. A launch with OSA or LCS on also counts under
"lev_jaro_fused.osa" / "lev_jaro_fused.lcs".
"""
from __future__ import annotations

from typing import Tuple

import torch

from strsim_tpu_torch.ops import _build, jaro_cuda, lcs, levenshtein_cuda, multiset_cuda, osa_cuda

MAX_WIDTH = 64  # two 32-bit equality words
_DTYPES = (torch.int8, torch.int32)


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def fields(with_inter: bool, with_osa: bool = False, with_lcs: bool = False) -> Tuple[str, ...]:
    """Names of the tensors `lev_jaro_stats` returns, in order."""
    return (("lev_d", "jaro_m", "jaro_t", "prefix")
            + tuple(f for f, on in (("inter", with_inter), ("osa_d", with_osa),
                                    ("lcs_len", with_lcs)) if on))


def lev_jaro_stats(a, b, len_a, len_b, with_inter: bool = False, with_osa: bool = False,
                   with_lcs: bool = False) -> Tuple[torch.Tensor, ...]:
    """[B] int32 tensors named by `fields(with_inter, with_osa, with_lcs)`;
    a, b: [B, L] int8/int32 tiles (rows may be column slices of a packed
    tile), len_a, len_b: [B] int32, L <= 64."""
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return lev_jaro_plain(a, b, len_a, len_b, with_inter, with_osa, with_lcs)
    names = fields(with_inter, with_osa, with_lcs)
    outs = {f: torch.empty(a.shape[0], dtype=torch.int32, device=a.device) for f in names}
    counts = ("lev_jaro_fused",) + tuple(
        f"lev_jaro_fused.{k}" for k, on in (("osa", with_osa), ("lcs", with_lcs)) if on)
    _build.launch("lev_jaro_fused", "strsim_lev_jaro_fused", counts, a, b, len_a, len_b,
                  tuple(outs.get(f) for f in ("lev_d", "jaro_m", "jaro_t", "prefix",
                                              "inter", "osa_d", "lcs_len")),
                  a.element_size())
    return tuple(outs.values())


def lev_jaro_plain(a, b, len_a, len_b, with_inter: bool = False, with_osa: bool = False,
                   with_lcs: bool = False) -> Tuple[torch.Tensor, ...]:
    """The separate plain versions on any device, in `fields` order."""
    # stats imports this module, so its prefix helper is looked up at call time
    from strsim_tpu_torch.ops.stats import shared_prefix_length

    lev = levenshtein_cuda.myers_plain(a, b, len_a, len_b)
    m, t = jaro_cuda.jaro_plain(a, b, len_a, len_b)
    outs = (lev, m, t, shared_prefix_length(a, b))
    if with_inter:
        outs += (multiset_cuda.rank_plain(a, b, len_a, len_b),)
    if with_osa:
        outs += (osa_cuda.osa_plain(a, b, len_a, len_b),)
    if with_lcs:
        outs += (lcs.lcs_plain(a, b, len_a, len_b),)
    return outs
