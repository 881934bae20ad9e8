"""Jaro match statistics (m, t): greedy windowed match and transpositions.

`jaro_match_stats` launches the hand-written CUDA kernel (csrc/jaro_scan.cu)
on CUDA tiles and runs `jaro_plain` on CPU tiles. `jaro_plain` is the greedy
scan in plain torch, the counterpart of
`strsim_tpu/ops/jaro_bitmask.py:jaro_match_stats_bitmask`; the pipeline also
uses it on CUDA for extend buckets wider than the kernel's 512.

Contract (both forms, every row; reference strsim.rs:197-243): bound =
max(la, lb) // 2 - 1; a-positions i < min(la, lb + bound) in order each flag
the first unflagged b-position j with b_j == a_i in
[max(i - bound, 0), min(i + bound, lb - 1)]; m counts the flags; t counts the
ranks where the r-th matched a char differs from the r-th flagged b char (raw,
before the finalizer's t // 2). la == lb == 1 gives m = (a_0 == b_0), t = 0.
Exact for every codepoint on int8 and int32 tiles.
"""
from __future__ import annotations

from typing import Tuple

import torch

from strsim_tpu_torch.ops import _build

MAX_WIDTH = 512
_DTYPES = (torch.int8, torch.int32)


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def jaro_match_stats(a, b, len_a, len_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B] m, [B] t) int32; a, b: [B, L] int8/int32 tiles (rows may be column
    slices of a packed tile), len_a, len_b: [B] int32, L <= 512."""
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return jaro_plain(a, b, len_a, len_b)
    m = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    t = torch.empty_like(m)
    _build.launch("jaro_scan", "strsim_jaro_scan", ("jaro_scan",),
                  a, b, len_a, len_b, (m, t), a.element_size())
    return m, t


def jaro_plain(a, b, len_a, len_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch greedy scan on any device: one step per a-position over
    [B, L] flag tensors, then the transposition count from the two
    rank-ordered compactions of the matched chars."""
    n, width = a.shape
    dev = a.device
    la = len_a.long()
    lb = len_b.long()
    bound = torch.maximum(la, lb) // 2 - 1
    jj = torch.arange(width, device=dev)
    i_end = torch.clamp(torch.minimum(la, lb + bound), 0, width)
    hi_cap = torch.clamp(lb, max=width) - 1

    flagged = torch.zeros((n, width), dtype=torch.bool, device=dev)
    matched = torch.zeros((n, width), dtype=torch.bool, device=dev)
    steps = int(i_end.max()) if n else 0
    for i in range(steps):
        lo = i - bound
        hi = torch.minimum(i + bound, hi_cap)
        window = (jj[None, :] >= lo[:, None]) & (jj[None, :] <= hi[:, None])
        active = (i < i_end)[:, None]
        cand = (b == a[:, i : i + 1]) & ~flagged & window & active
        found = cand.any(1)
        first = cand.to(torch.uint8).argmax(1)  # first True (ties -> first)
        flagged |= (jj[None, :] == first[:, None]) & found[:, None]
        matched[:, i] = found

    m = matched.sum(1)
    # r-th matched a char vs r-th flagged b char: sort positions so the
    # flagged ones come first, in order
    order_a = torch.sort(torch.where(matched, jj, jj + width), dim=1).indices
    order_b = torch.sort(torch.where(flagged, jj, jj + width), dim=1).indices
    differ = a.gather(1, order_a) != b.gather(1, order_b)
    t = (differ & (jj[None, :] < m[:, None])).sum(1)

    one_one = (la == 1) & (lb == 1)
    m = torch.where(one_one, (a[:, 0] == b[:, 0]).long(), m)
    t = torch.where(one_one, 0, t)
    return m.to(torch.int32), t.to(torch.int32)
