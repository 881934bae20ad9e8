"""Multiword bit vectors in plain torch, for the plain versions of the
bit-parallel DP kernels (Myers levenshtein, Hyyro OSA, Allison-Dix LCS).

A row's bit vector is W words of 32 bits, held as [B, W] int64 tensors whose
values stay in [0, 2^32) (torch has no uint32 shifts on the CPU, so every
operation that can set higher bits is masked back). Word w holds bits
32w .. 32w + 31; carries and shift-outs run from word w to word w + 1, as in
the CUDA kernels' unrolled word loops.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def n_words(width: int) -> int:
    return -(-width // 32)


class PatternEq:
    """Equality words of pattern `a` against one text char per row: bit i of
    the result is (i < len_a) & (a_i == c)."""

    def __init__(self, a: torch.Tensor, len_a: torch.Tensor):
        n, width = a.shape
        self.n, self.words = n, n_words(width)
        pos = torch.arange(32 * self.words, device=a.device)
        self.pattern = torch.full((n, 32 * self.words), -1, dtype=torch.int32, device=a.device)
        self.pattern[:, :width] = a
        self.valid = pos[None, :] < len_a.long()[:, None]
        self.weights = torch.bitwise_left_shift(torch.ones_like(pos), pos % 32)

    def __call__(self, c: torch.Tensor) -> torch.Tensor:
        """c: [B, 1] text chars -> [B, W] words."""
        hits = (self.pattern == c) & self.valid
        return (hits.long() * self.weights).view(self.n, self.words, 32).sum(-1)


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x + y) mod 2^(32W) word by word. The carry into word w is the carry
    out of the last word k < w that does not merely propagate (it generates,
    or kills): a carry-lookahead, so an addition costs the same few tensor ops
    at every width."""
    n, words = x.shape
    word_ids = torch.arange(words, device=x.device)
    s = x + y  # < 2^33 before the carry in
    gen = s >> 32
    prop = (s & MASK) == MASK
    stop = torch.where((gen == 1) | ~prop, word_ids[None, :], -1)
    none = torch.full((n, 1), -1, dtype=torch.int64, device=x.device)
    last = torch.cat([none, torch.cummax(stop, dim=1).values[:, :-1]], 1)
    carry = torch.where(last >= 0, gen.gather(1, last.clamp(min=0)), 0)
    return (s + carry) & MASK


def shl1(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x << 1 over the whole vector, `fill` (0 or 1) into bit 0."""
    first = torch.full((x.shape[0], 1), fill, dtype=torch.int64, device=x.device)
    return ((x << 1) & MASK) | torch.cat([first, x[:, :-1] >> 31], 1)


def invert(x: torch.Tensor) -> torch.Tensor:
    return ~x & MASK


class BitAt:
    """Reads bit `pos` ([B], >= 0) of [B, W] words."""

    def __init__(self, pos: torch.Tensor, words: int):
        word_ids = torch.arange(words, device=pos.device)
        self.track = word_ids[None, :] == (pos // 32)[:, None]
        self.bit = (pos % 32)[:, None]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (((x >> self.bit) & 1) * self.track).sum(1)


def low_mask(count: torch.Tensor, words: int) -> torch.Tensor:
    """[B, W] words with bits [0, count) set, count: [B]."""
    word_ids = torch.arange(words, device=count.device)
    k = (count.long()[:, None] - 32 * word_ids[None, :]).clamp(0, 32)
    return (torch.bitwise_left_shift(torch.ones_like(k), k) - 1) & MASK


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR), same shape as x."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK) >> 24
