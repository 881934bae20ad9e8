"""Shared-equality fused stats for lev + jaro requests at widths <= 64.

`lev_jaro_stats` launches the hand-written CUDA kernel
(csrc/lev_jaro_fused.cu) on CUDA tiles and runs `lev_jaro_plain` on CPU
tiles. It is the counterpart of
`strsim_tpu/ops/lev_jaro_pallas.py:fused_stats_pallas`: one equality build a
row serves the Myers distance, the jaro greedy scan, the multiset count and
the 4-capped prefix, where the separate kernels would each rebuild their share
of it. `ops/stats.py:compute_stats` takes it whenever lev_d and jaro_m are both
needed at these widths, as the JAX engine does.

Contract (both forms, every row): the stats of the separate kernels on the
same tiles: lev_d as `levenshtein_cuda.myers_plain`, (jaro_m, jaro_t) as
`jaro_cuda.jaro_plain`, prefix as `stats.shared_prefix_length` and, with
`with_inter`, inter as `multiset_cuda.rank_plain`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from strsim_tpu_torch.ops import _build, jaro_cuda, levenshtein_cuda, multiset_cuda

MAX_WIDTH = 64  # two 32-bit equality words
_DTYPES = (torch.int8, torch.int32)


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def fields(with_inter: bool) -> Tuple[str, ...]:
    """Names of the tensors `lev_jaro_stats` returns, in order."""
    return ("lev_d", "jaro_m", "jaro_t", "prefix") + (("inter",) if with_inter else ())


def lev_jaro_stats(a, b, len_a, len_b, with_inter: bool = False) -> Tuple[torch.Tensor, ...]:
    """[B] int32 tensors named by `fields(with_inter)`; a, b: [B, L] int8/int32
    tiles (rows may be column slices of a packed tile), len_a, len_b: [B]
    int32, L <= 64."""
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return lev_jaro_plain(a, b, len_a, len_b, with_inter)
    n, width = a.shape
    outs = tuple(torch.empty(n, dtype=torch.int32, device=a.device)
                 for _ in fields(with_inter))
    if n == 0:
        return outs
    lib = _build.library("lev_jaro_fused")
    inter_ptr = outs[4].data_ptr() if with_inter else None
    with torch.cuda.device(a.device):
        rc = lib.strsim_lev_jaro_fused(
            a.data_ptr(), b.data_ptr(), a.stride(0), b.stride(0),
            len_a.data_ptr(), len_b.data_ptr(),
            *(o.data_ptr() for o in outs[:4]), inter_ptr,
            n, width, a.element_size(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("lev_jaro_fused", rc)
    return outs


def lev_jaro_plain(a, b, len_a, len_b, with_inter: bool = False) -> Tuple[torch.Tensor, ...]:
    """The separate plain versions on any device, in `fields` order."""
    # stats imports this module, so its prefix helper is looked up at call time
    from strsim_tpu_torch.ops.stats import shared_prefix_length

    lev = levenshtein_cuda.myers_plain(a, b, len_a, len_b)
    m, t = jaro_cuda.jaro_plain(a, b, len_a, len_b)
    outs = (lev, m, t, shared_prefix_length(a, b))
    if with_inter:
        outs += (multiset_cuda.rank_plain(a, b, len_a, len_b),)
    return outs
