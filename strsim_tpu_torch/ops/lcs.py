"""Longest-common-subsequence length: Allison-Dix bit-parallel row vector.

`lcs_plain` is the plain torch version, the counterpart of
`strsim_tpu/ops/lcs.py:lcs_length`. It is the plain form of the LCS output of
the fused DP kernel (csrc/dp_fused.cu, `dp_fused_cuda.dp_fused_stats`) and of
K5 (`lev_jaro_cuda.lev_jaro_stats(with_lcs=True)`); the pipeline also uses it
on CUDA for extend buckets wider than those kernels' 512.

Contract (every row): pattern a, text b; per text char b_j < len_b with
equality word M (bit i = (i < len_a) & (a_i == b_j)):

    U = V & M
    V = (V + U) | (V ^ U)

from V = all ones; lcs = len_a - popcount(V & mask(len_a)). U is a subset of
V, so V - U never borrows and equals V ^ U; carries past bit len_a - 1 never
flow back down, so the mask is applied once at the end. Rows with an empty
side give 0.
"""
from __future__ import annotations

import torch

from strsim_tpu_torch.ops import bitwords


def lcs_plain(a, b, len_a, len_b) -> torch.Tensor:
    """[B] int32 LCS lengths; a, b: [B, L] tiles, len_a, len_b: [B] int32."""
    n, width = a.shape
    eq_of = bitwords.PatternEq(a, len_a)
    lb = len_b.long()
    text = b.to(torch.int32)
    v = torch.full((n, eq_of.words), bitwords.MASK, dtype=torch.int64, device=a.device)
    steps = int(torch.clamp(lb, 0, width).max()) if n else 0
    for j in range(steps):
        u = v & eq_of(text[:, j : j + 1])
        active = (j < lb)[:, None]
        v = torch.where(active, bitwords.add(v, u) | (v ^ u), v)
    ones = bitwords.popcount(v & bitwords.low_mask(len_a, eq_of.words)).sum(1)
    return (len_a.long() - ones).to(torch.int32)
