"""Fused bit-parallel DP: two or more of lev_d / osa_d / lcs_len, or lcs_len
alone, from one equality-word build per text char.

`dp_fused_stats` launches the hand-written CUDA kernel (csrc/dp_fused.cu) on
CUDA tiles and runs `dp_fused_plain` on CPU tiles. It is the counterpart of
`strsim_tpu/ops/dp_fused_pallas.py:dp_fused_stats_pallas`: Myers, Hyyro OSA
and Allison-Dix LCS all take a as the pattern and b as the text, so they
consume the same Eq word per text char, which the kernel builds once for the
requested recurrences. `ops/stats.py:stat_routes` takes it when at least two
of {lev (not already from K5), osa, lcs} are wanted, or lcs alone.

Contract (both forms, every row): the stats of the separate plain versions
on the same tiles, in the order lev_d, osa_d, lcs_len (only those requested):
`levenshtein_cuda.myers_plain`, `osa_cuda.osa_plain`, `lcs.lcs_plain`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from strsim_tpu_torch.ops import _build, lcs, levenshtein_cuda, osa_cuda

MAX_WIDTH = 512
_DTYPES = (torch.int8, torch.int32)


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def fields(with_lev: bool, with_osa: bool, with_lcs: bool) -> Tuple[str, ...]:
    """Names of the tensors `dp_fused_stats` returns, in order."""
    return tuple(f for f, on in (("lev_d", with_lev), ("osa_d", with_osa),
                                 ("lcs_len", with_lcs)) if on)


def dp_fused_stats(a, b, len_a, len_b, with_lev=False, with_osa=False,
                   with_lcs=False) -> Tuple[torch.Tensor, ...]:
    """[B] int32 tensors named by `fields(...)`; a, b: [B, L] int8/int32
    tiles (rows may be column slices of a packed tile), len_a, len_b: [B]
    int32, L <= 512. Two or more recurrences, or lcs alone: lev alone is
    `levenshtein_cuda.levenshtein_distance`'s (K1) and osa alone
    `osa_cuda.osa_distance`'s (K7), the same scan kernel."""
    names = fields(with_lev, with_osa, with_lcs)
    if not names:
        raise ValueError("at least one of with_lev, with_osa, with_lcs")
    if names in (("lev_d",), ("osa_d",)):
        raise ValueError(f"{names[0]} alone is levenshtein_distance's or osa_distance's, "
                         "not the fused kernel's")
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return dp_fused_plain(a, b, len_a, len_b, with_lev, with_osa, with_lcs)
    outs = {f: torch.empty(a.shape[0], dtype=torch.int32, device=a.device) for f in names}
    _build.launch("dp_fused", "strsim_dp_fused", ("dp_fused",), a, b, len_a, len_b,
                  tuple(outs.get(f) for f in ("lev_d", "osa_d", "lcs_len")), a.element_size())
    return tuple(outs.values())


def dp_fused_plain(a, b, len_a, len_b, with_lev=False, with_osa=False,
                   with_lcs=False) -> Tuple[torch.Tensor, ...]:
    """The separate plain versions on any device, in `fields` order."""
    plain = {"lev_d": levenshtein_cuda.myers_plain, "osa_d": osa_cuda.osa_plain,
             "lcs_len": lcs.lcs_plain}
    return tuple(plain[f](a, b, len_a, len_b) for f in fields(with_lev, with_osa, with_lcs))
