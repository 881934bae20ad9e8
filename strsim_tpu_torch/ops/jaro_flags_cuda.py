"""Jaro match statistics (m, t) by the flag-emitting greedy scan (K9).

The counterpart of `strsim_tpu/ops/jaro_pallas.py:jaro_match_stats_pallas`,
which only a forced `jaro_impl="pallas"` reaches. Its kernel runs the greedy
scan alone and emits the match count with both flag tensors; the
transposition count and the len-1/len-1 patch run outside the kernel, as the
JAX wrapper runs them in XLA (`jaro_pallas.py:114-127`).

`jaro_flag_scan` launches the hand-written CUDA kernel (csrc/jaro_flags.cu)
on CUDA tiles and runs `jaro_cuda.greedy_scan` on CPU tiles; both return
([B] int32 m, [B, L] bool matched_a, [B, L] bool flagged_b) under the
contract of `ops/jaro_cuda.py`, with m counted before the len-1/len-1 patch.
`jaro_match_stats` adds the plain `transposition_count` and `patch_one_one`,
so its (m, t) equal `jaro_cuda.jaro_plain`'s, and K2's, on every row.
"""
from __future__ import annotations

from typing import Tuple

import torch

from strsim_tpu_torch.ops import _build, jaro_cuda

MAX_WIDTH = 512  # 16 flag words of 32 bits: the whole bucket ladder
_DTYPES = (torch.int8, torch.int32)


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def jaro_flag_scan(a, b, len_a, len_b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(m, matched_a, flagged_b); a, b: [B, L] int8/int32 tiles (rows may be
    column slices of a packed tile), len_a, len_b: [B] int32, L <= 512."""
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return jaro_cuda.greedy_scan(a, b, len_a, len_b)
    n, width = a.shape
    m = torch.empty(n, dtype=torch.int32, device=a.device)
    matched = torch.empty((n, width), dtype=torch.bool, device=a.device)
    flagged = torch.empty_like(matched)
    _build.launch("jaro_flags", "strsim_jaro_flags", ("jaro_flags",),
                  a, b, len_a, len_b, (m, matched, flagged), a.element_size())
    return m, matched, flagged


def jaro_match_stats(a, b, len_a, len_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B] m, [B] t) int32 on the tiles' device, as `jaro_cuda.jaro_plain`."""
    m, matched, flagged = jaro_flag_scan(a, b, len_a, len_b)
    t = jaro_cuda.transposition_count(a, b, matched, flagged)
    return jaro_cuda.patch_one_one(a, b, len_a, len_b, m, t)
