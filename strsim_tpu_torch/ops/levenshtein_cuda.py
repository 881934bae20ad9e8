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

from strsim_tpu_torch.ops import _build

MAX_WIDTH = 512  # 16 words of 32 bits: the whole bucket ladder
_MASK = 0xFFFFFFFF
_DTYPES = (torch.int8, torch.int32)


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def levenshtein_distance(a, b, len_a, len_b) -> torch.Tensor:
    """[B] int32 distances; a, b: [B, L] int8/int32 tiles (rows may be column
    slices of a packed tile), len_a, len_b: [B] int32, L <= 512."""
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return myers_plain(a, b, len_a, len_b)
    n, width = a.shape
    out = torch.empty(n, dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    lib = _build.library("levenshtein_myers")
    with torch.cuda.device(a.device):
        rc = lib.strsim_levenshtein_myers(
            a.data_ptr(), b.data_ptr(), a.stride(0), b.stride(0),
            len_a.data_ptr(), len_b.data_ptr(), out.data_ptr(),
            n, width, a.element_size(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch("levenshtein_myers", rc)
    return out


def myers_plain(a, b, len_a, len_b) -> torch.Tensor:
    """Plain torch Myers on any device. 32-bit words are held in int64 and
    masked to 32 bits (torch has no uint32 shifts on the CPU); the word-to-word
    addition carry is resolved per step with a carry-lookahead over the words,
    so a step costs the same few tensor ops at every width."""
    n, width = a.shape
    dev = a.device
    words = -(-width // 32)
    la = len_a.long()
    lb = len_b.long()
    pos = torch.arange(32 * words, device=dev)
    pattern = torch.full((n, 32 * words), -1, dtype=torch.int32, device=dev)
    pattern[:, :width] = a
    pattern_valid = pos[None, :] < la[:, None]
    weights = torch.bitwise_left_shift(torch.ones_like(pos), pos % 32)
    word_ids = torch.arange(words, device=dev)
    text = b.to(torch.int32)

    m1 = torch.clamp(la - 1, min=0)
    track = word_ids[None, :] == (m1 // 32)[:, None]  # [B, W]: word of bit la-1
    hbit = (m1 % 32)[:, None]
    first = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    no_stop = torch.full((n, 1), -1, dtype=torch.int64, device=dev)

    pv = torch.full((n, words), _MASK, dtype=torch.int64, device=dev)
    mv = torch.zeros((n, words), dtype=torch.int64, device=dev)
    score = la.clone()
    steps = int(torch.clamp(lb, 0, width).max()) if n else 0
    for j in range(steps):
        hits = (pattern == text[:, j : j + 1]) & pattern_valid
        eq = (hits.long() * weights).view(n, words, 32).sum(-1)
        x = eq & pv
        s = x + pv  # < 2^33 before the carry in
        gen = s >> 32
        prop = (s & _MASK) == _MASK
        # carry into word w = carry out of the last word k < w that does not
        # merely propagate (it generates, or kills); none -> the initial 0
        stop = torch.where((gen == 1) | ~prop, word_ids[None, :], -1)
        last = torch.cat([no_stop, torch.cummax(stop, dim=1).values[:, :-1]], 1)
        carry = torch.where(last >= 0, gen.gather(1, last.clamp(min=0)), 0)
        s2 = (s + carry) & _MASK
        xh = (s2 ^ pv) | eq
        xv = eq | mv
        ph = mv | (~(xh | pv) & _MASK)
        mh = pv & xh
        ph_bit = (((ph >> hbit) & 1) * track).sum(1)
        mh_bit = (((mh >> hbit) & 1) * track).sum(1)
        ph_s = ((ph << 1) & _MASK) | torch.cat([first + 1, ph[:, :-1] >> 31], 1)
        mh_s = ((mh << 1) & _MASK) | torch.cat([first, mh[:, :-1] >> 31], 1)
        active = (j < lb)[:, None]
        pv = torch.where(active, mh_s | (~(xv | ph_s) & _MASK), pv)
        mv = torch.where(active, ph_s & xv, mv)
        score = score + torch.where(active[:, 0], ph_bit - mh_bit, 0)
    return score.to(torch.int32)
