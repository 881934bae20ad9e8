"""Levenshtein distance: Myers/Hyyro bit-parallel column DP.

`levenshtein_distance` launches the hand-written CUDA kernel
(csrc/levenshtein_myers.cu) on CUDA tiles and runs `myers_plain` on CPU
tiles. `myers_plain` is the same recurrence in plain torch, the counterpart of
`strsim_tpu/ops/levenshtein_myers.py:levenshtein_distance_myers`; the pipeline
also uses it on CUDA for extend buckets wider than the kernel's 512.

Contract (both forms, every row): pattern a, text b; Eq_j bit i is
(i < len_a) & (a_i == b_j); pv starts all ones, mv zero, the score starts at
len_a and steps j < len_b move it by the Ph/Mh bits at position len_a - 1.
That is the unit-cost edit distance wherever both lengths are >= 1; rows with
an empty side return a value the host finalizer ignores.
"""
from __future__ import annotations

import torch

from strsim_tpu_torch.ops import _build, bitwords

MAX_WIDTH = 512  # 16 words of 32 bits: the whole bucket ladder
_DTYPES = (torch.int8, torch.int32)


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def levenshtein_distance(a, b, len_a, len_b) -> torch.Tensor:
    """[B] int32 distances; a, b: [B, L] int8/int32 tiles (rows may be column
    slices of a packed tile), len_a, len_b: [B] int32, L <= 512."""
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return myers_plain(a, b, len_a, len_b)
    out = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    _build.launch("levenshtein_myers", "strsim_levenshtein_myers", ("levenshtein_myers",),
                  a, b, len_a, len_b, (out,), a.element_size())
    return out


def myers_plain(a, b, len_a, len_b) -> torch.Tensor:
    """Plain torch Myers on any device, over the 32-bit words of
    `ops/bitwords.py` (int64 tensors masked to 32 bits, carry-lookahead
    addition), so a step costs the same few tensor ops at every width."""
    n, width = a.shape
    eq_of = bitwords.PatternEq(a, len_a)
    lb = len_b.long()
    score_bit = bitwords.BitAt(torch.clamp(len_a.long() - 1, min=0), eq_of.words)
    text = b.to(torch.int32)

    pv = torch.full((n, eq_of.words), bitwords.MASK, dtype=torch.int64, device=a.device)
    mv = torch.zeros_like(pv)
    score = len_a.long().clone()
    steps = int(torch.clamp(lb, 0, width).max()) if n else 0
    for j in range(steps):
        eq = eq_of(text[:, j : j + 1])
        xh = (bitwords.add(eq & pv, pv) ^ pv) | eq
        xv = eq | mv
        ph = mv | bitwords.invert(xh | pv)
        mh = pv & xh
        ph_s = bitwords.shl1(ph, 1)
        mh_s = bitwords.shl1(mh, 0)
        active = (j < lb)[:, None]
        pv = torch.where(active, mh_s | bitwords.invert(xv | ph_s), pv)
        mv = torch.where(active, ph_s & xv, mv)
        score = score + torch.where(active[:, 0], score_bit(ph) - score_bit(mh), 0)
    return score.to(torch.int32)
