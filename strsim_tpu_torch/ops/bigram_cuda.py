"""Bigram multiset intersection, with the positional-match and row-equality
stats it carries.

`bigram_stats` launches the hand-written CUDA kernel (csrc/bigram.cu) on CUDA
tiles at widths <= 64 and runs `bigram_plain` on CPU tiles. It is the
counterpart of `strsim_tpu/ops/bigram_pallas.py:bigram_stats_pallas`;
`bigram_plain` is that of `strsim_tpu/ops/multiset_loop.py:
bigram_intersection_loop` with the XLA ham_m and row_equal stats
(`strsim_tpu/ops/stats.py`), and the pipeline uses it on CUDA for buckets
wider than 64.

Contract (both forms, every row), returning (inter2, ham_m, eq):
  inter2  sum over bigrams g of min(cnt_a(g), cnt_b(g)), where row i has the
          len - 1 bigrams (x_k, x_k+1), k < len - 1: bigram i < len_a - 1 of
          a counts iff its occurrence rank among equal bigrams of a is below
          its count among the bigrams of b. Pads (-1 / -2) differ per side
          and from every char, so a bigram that reaches a pad matches
          nothing across sides. A side with fewer than 2 chars gives 0.
  ham_m   positional matches sum_i (a_i == b_i) over the whole width.
  eq      (len_a == len_b) & (ham_m == len_a): the rows are equal strings.
"""
from __future__ import annotations

from typing import Tuple

import torch

from strsim_tpu_torch.ops import _build

MAX_WIDTH = 64
_DTYPES = (torch.int8, torch.int32)
_CHUNK = 16  # a-positions per fused [B, chunk, L] compare in bigram_plain


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def bigram_stats(a, b, len_a, len_b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """([B] inter2, [B] ham_m, [B] eq) int32; a, b: [B, L] int8/int32 tiles
    (rows may be column slices of a packed tile), len_a, len_b: [B] int32,
    L <= 64."""
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return bigram_plain(a, b, len_a, len_b)
    outs = tuple(torch.empty(a.shape[0], dtype=torch.int32, device=a.device) for _ in range(3))
    _build.launch("bigram", "strsim_bigram", ("bigram",), a, b, len_a, len_b, outs,
                  a.element_size())
    return outs


def ham_plain(a, b) -> torch.Tensor:
    """Positional matches per row (pads differ per side, so positions past
    either length never match)."""
    return (a == b).sum(1).to(torch.int32)


def bigram_plain(a, b, len_a, len_b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch (inter2, ham_m, eq) on any device, _CHUNK a-bigrams per
    fused compare-reduce."""
    n, width = a.shape
    ham = ham_plain(a, b)
    eq = ((len_a == len_b) & (ham == len_a)).to(torch.int32)
    inter = torch.zeros(n, dtype=torch.int64, device=a.device)
    if width < 2:
        return inter.to(torch.int32), ham, eq
    a0, a1, b0, b1 = a[:, :-1], a[:, 1:], b[:, :-1], b[:, 1:]
    valid_to = len_a.long()[:, None] - 1  # bigram i of a is real iff i < len_a - 1
    kk = torch.arange(width - 1, device=a.device)
    steps = int(torch.clamp(len_a.long() - 1, 0, width - 1).max()) if n else 0
    for i0 in range(0, steps, _CHUNK):
        ii = torch.arange(i0, min(i0 + _CHUNK, width - 1), device=a.device)
        g0 = a0[:, ii, None]  # [B, G, 1]
        g1 = a1[:, ii, None]
        cnt_b = ((g0 == b0[:, None, :]) & (g1 == b1[:, None, :])).sum(2)
        before = kk[None, :] < ii[:, None]  # [G, L - 1]: k strictly before i
        occ = ((g0 == a0[:, None, :]) & (g1 == a1[:, None, :]) & before[None]).sum(2)
        inter += ((occ < cnt_b) & (ii[None, :] < valid_to)).sum(1)
    return inter.to(torch.int32), ham, eq
