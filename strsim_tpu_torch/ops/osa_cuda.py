"""OSA (restricted Damerau-Levenshtein) distance: Hyyro's bit-parallel D0
formulation.

`osa_distance` launches the hand-written CUDA kernel (csrc/osa_scan.cu) on
CUDA tiles and runs `osa_plain` on CPU tiles. `osa_plain` is the same
recurrence in plain torch, the counterpart of
`strsim_tpu/ops/osa_myers.py:osa_distance_myers`; the pipeline also uses it
on CUDA for extend buckets wider than the kernel's 512.

Contract (both forms, every row): pattern a, text b, per text char b_j <
len_b with equality word PM (bit i = (i < len_a) & (a_i == b_j)) and D0', PM'
carried from step j - 1 (zero before the first step):

    TR = (((~D0') & PM) << 1) & PM'
    D0 = (((PM & PV) + PV) ^ PV) | PM | MV | TR
    HP = MV | ~(D0 | PV);  HN = D0 & PV
    score += bit len_a - 1 of HP - that of HN
    PV = (HN << 1) | ~(D0 | (HP << 1 | 1));  MV = (HP << 1 | 1) & D0

from PV = all ones, MV = 0, score = len_a. TR must enter D0 before HP/HN are
derived from it, and each left shift carries bit 31 of word w into bit 0 of
word w + 1 (TR's shift too). That is the OSA distance wherever both lengths
are >= 1; rows with an empty side return len_a (len_b == 0) or
max(len_b - 1, 0) (len_a == 0), which the finalizer ignores.
"""
from __future__ import annotations

import torch

from strsim_tpu_torch.ops import _build, bitwords

MAX_WIDTH = 512
_DTYPES = (torch.int8, torch.int32)


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def osa_distance(a, b, len_a, len_b) -> torch.Tensor:
    """[B] int32 OSA distances; a, b: [B, L] int8/int32 tiles (rows may be
    column slices of a packed tile), len_a, len_b: [B] int32, L <= 512."""
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return osa_plain(a, b, len_a, len_b)
    out = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    _build.launch("osa_scan", "strsim_osa_distance", ("osa_scan",),
                  a, b, len_a, len_b, (out,), a.element_size())
    return out


def osa_plain(a, b, len_a, len_b) -> torch.Tensor:
    """Plain torch Hyyro OSA on any device, over `ops/bitwords.py` words."""
    n, width = a.shape
    eq_of = bitwords.PatternEq(a, len_a)
    lb = len_b.long()
    score_bit = bitwords.BitAt(torch.clamp(len_a.long() - 1, min=0), eq_of.words)
    text = b.to(torch.int32)

    pv = torch.full((n, eq_of.words), bitwords.MASK, dtype=torch.int64, device=a.device)
    mv = torch.zeros_like(pv)
    d0_prev = torch.zeros_like(pv)
    eq_prev = torch.zeros_like(pv)
    score = len_a.long().clone()
    steps = int(torch.clamp(lb, 0, width).max()) if n else 0
    for j in range(steps):
        eq = eq_of(text[:, j : j + 1])
        tr = bitwords.shl1(bitwords.invert(d0_prev) & eq, 0) & eq_prev
        d0 = (bitwords.add(eq & pv, pv) ^ pv) | eq | mv | tr
        hp = mv | bitwords.invert(d0 | pv)
        hn = d0 & pv
        hp_s = bitwords.shl1(hp, 1)
        hn_s = bitwords.shl1(hn, 0)
        active = (j < lb)[:, None]
        pv = torch.where(active, hn_s | bitwords.invert(d0 | hp_s), pv)
        mv = torch.where(active, hp_s & d0, mv)
        d0_prev = torch.where(active, d0, d0_prev)
        eq_prev = torch.where(active, eq, eq_prev)
        score = score + torch.where(active[:, 0], score_bit(hp) - score_bit(hn), 0)
    return score.to(torch.int32)
