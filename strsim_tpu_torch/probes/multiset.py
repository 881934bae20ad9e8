"""Three A/B probes of the multiset intersection K3
(`ops/multiset_cuda.py:multiset_intersection_rank`), K20-K22.

Each is a hand-written CUDA kernel (`csrc/probe_multiset.cu`) with its plain
torch version here, the counterpart of the TPU probes of `tools/`:

  K20 `multiset_unrolled`  tools/ab_multiset_pallas.py `_kernel` :39 (mode
      "select": where(eq, 1, 0) added), tools/ab_multiset_r3.py
      `_kernel_tree` :40 ("tree": balanced pairwise sums) and
      `_kernel_astype` :66 ("astype": the bool added as int); one template,
      the modes differing only in how a compare is accumulated.
  K21 `multiset_swar`      tools/ab_multiset_r3.py `_kernel_swar` :89: four
      chars a 32-bit word, the exact zero-byte test of their xor, per-byte
      counts summed by `* 0x01010101 >> 24`; int8 tiles only.
  K22 `multiset_blocked`   tools/ab_multiset_r3.py `_kernel_blocked` :140:
      `gi` (4 or 8) a-positions compared with each char read.

All compute the TPU bodies' occurrence-rank count: for every a-position
i < L, cnt_b(i) = #{j < L : b_j == a_i} and occ(i) = #{k < i : a_k == a_i};
the count is of the i < la with occ(i) < cnt_b(i). Like the TPU bodies they
take the tiles and `len_a` only, no `len_b`: the pads (utils/encode.py's
PAD_A = -1 past la, PAD_B = -2 past lb) keep b's tail from matching, so on
the encoder's tiles (chars >= 0) the count equals `rank_plain`'s. K21
compares bytes, a's chars below 0 read as 255 and b's as 254 (the tool's
pads). Unlike the TPU's `_kernel_swar`, which left the unused bytes of b's
short last word at 0, so that a NUL a-char matched them, K21 and its plain
version fill them with 254.

Widths: the narrow ladder only (`WIDTHS`, chip_smoke.NARROW); the kernels
are built for each. The TPU tools' `block_rows` sweeps (8192 and 32768 in
ab_multiset_pallas.py, "swar/br16k" in ab_multiset_r3.py) and their `SUB`
(the TPU's sublane fold of a block) are grid blocks with no counterpart on
the card: the kernels give a row a thread, 128 threads a block.

The wrappers launch their kernel on CUDA tensors (a build or launch failure
raises) and run the plain version on CPU tensors; any other device raises.
Tiles follow `ops/_build.py:check_tiles`. Launch counts:
"multiset_unrolled" and "multiset_unrolled.<mode>", "multiset_swar",
"multiset_blocked".
"""
from __future__ import annotations

import torch

from strsim_tpu_torch.ops import _build
from strsim_tpu_torch.probes.myers import MASK, _check_int8

WIDTHS = (7, 15, 23, 31, 47, 63)
MODES = ("select", "tree", "astype")  # K20's, in the C entry point's order
GROUPS = (4, 8)  # K22's a-positions a read
_DTYPES = (torch.int8, torch.int32)
_CHUNK = 16  # a-positions per fused [B, chunk, L] compare in the plain versions


def _on_card(a, b, len_a, dtypes) -> bool:
    """`check_tiles` on the tiles and len_a (no len_b), then the width."""
    on_card = _build.check_tiles(a, b, len_a, len_a, WIDTHS[-1], dtypes)
    if a.shape[1] not in WIDTHS:
        raise ValueError(f"tile width {a.shape[1]} outside the narrow ladder {WIDTHS}")
    return on_card


def _launch(fn: str, counts, a, b, len_a, *args) -> torch.Tensor:
    n, width = a.shape
    out = torch.empty(n, dtype=torch.int32, device=a.device)
    if n:
        _build.call("probe_multiset", fn, counts, a.device, a.data_ptr(), b.data_ptr(),
                    a.stride(0), b.stride(0), len_a.data_ptr(), out.data_ptr(), n, width, *args)
    return out


def _by_compares(a, b, len_a) -> torch.Tensor:
    """The compare bodies' count on any device, _CHUNK a-positions per
    fused compare-reduce."""
    n, width = a.shape
    dev = a.device
    la = len_a.long()
    kk = torch.arange(width, device=dev)
    inter = torch.zeros(n, dtype=torch.int64, device=dev)
    for i0 in range(0, width, _CHUNK):
        ii = torch.arange(i0, min(i0 + _CHUNK, width), device=dev)
        ai = a[:, i0: i0 + ii.numel(), None]  # [B, G, 1]
        cnt = (ai == b[:, None, :]).sum(2)
        occ = ((ai == a[:, None, :]) & (kk[None, :] < ii[:, None])[None]).sum(2)
        inter += ((occ < cnt) & (ii[None, :] < la[:, None])).sum(1)
    return inter.to(torch.int32)


# --- K20: compare, accumulate, all unrolled ---------------------------------------

def multiset_unrolled(a, b, len_a, mode: str = "select") -> torch.Tensor:
    """K20: [B] int32; a, b: [B, L] int8/int32 tiles, L on the ladder;
    `mode` one of MODES."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if not _on_card(a, b, len_a, _DTYPES):
        return multiset_unrolled_plain(a, b, len_a, mode)
    return _launch("strsim_probe_multiset_unrolled",
                   ("multiset_unrolled", f"multiset_unrolled.{mode}"), a, b, len_a,
                   a.element_size(), MODES.index(mode))


def multiset_unrolled_plain(a, b, len_a, mode: str = "select") -> torch.Tensor:
    """Every mode sums the same compares: one count."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return _by_compares(a, b, len_a)


# --- K21: four chars a word ---------------------------------------------------------

_L7F, _H80, _REPL = 0x7F7F7F7F, 0x80808080, 0x01010101


def multiset_swar(a, b, len_a) -> torch.Tensor:
    """K21: [B] int32; a, b: [B, L] int8 tiles, L on the ladder. int32
    tiles raise TypeError: their chars do not fit a byte."""
    _check_int8("multiset_swar", a, b)
    if not _on_card(a, b, len_a, (torch.int8,)):
        return multiset_swar_plain(a, b, len_a)
    return _launch("strsim_probe_multiset_swar", ("multiset_swar",), a, b, len_a)


def swar_words(x, pad: int) -> torch.Tensor:
    """[B, ceil(L / 4)] int64: byte p of word w is char 4w + p of the row,
    chars below 0 and the bytes past L `pad` (a: 255, b: 254)."""
    n, width = x.shape
    words = -(-width // 4)
    c = torch.full((n, 4 * words), pad, dtype=torch.int64, device=x.device)
    c[:, :width] = torch.where(x < 0, pad, x.long())
    shifts = torch.tensor([0, 8, 16, 24], device=x.device)
    return (c.view(n, words, 4) << shifts).sum(2)  # disjoint bytes: the sum is the OR


def _zero_bytes(x):
    """0x80 in each zero byte of the 32-bit words x, exact."""
    return ~(((x & _L7F) + _L7F) | x) & _H80


def multiset_swar_plain(a, b, len_a) -> torch.Tensor:
    """The TPU body's word arithmetic (`_kernel_swar`) over int64 words
    masked to 32 bits, b's fill bytes 254; int8 tiles only."""
    _check_int8("multiset_swar", a, b)
    n, width = a.shape
    aw, bw = swar_words(a, 0xFF), swar_words(b, 0xFE)
    la = len_a.long()
    inter = torch.zeros(n, dtype=torch.int64, device=a.device)
    for i in range(width):
        aa = (((aw[:, i // 4] >> (8 * (i % 4))) & 0xFF) * _REPL)[:, None]
        acc_b = (_zero_bytes(bw ^ aa) >> 7).sum(1)  # a count in each byte
        z = _zero_bytes(aw[:, : (i + 3) // 4] ^ aa) >> 7
        if i % 4:  # the boundary word: only bytes k < i
            z[:, -1] &= (1 << (8 * (i % 4))) - 1
        cnt = ((acc_b * _REPL) & MASK) >> 24
        occ = ((z.sum(1) * _REPL) & MASK) >> 24
        inter += ((occ < cnt) & (i < la)).long()
    return inter.to(torch.int32)


# --- K22: gi a-positions a read -------------------------------------------------------

def multiset_blocked(a, b, len_a, gi: int = 4) -> torch.Tensor:
    """K22: [B] int32; a, b: [B, L] int8/int32 tiles, L on the ladder; `gi`
    one of GROUPS."""
    if gi not in GROUPS:
        raise ValueError(f"gi {gi!r} not in {GROUPS}")
    if not _on_card(a, b, len_a, _DTYPES):
        return multiset_blocked_plain(a, b, len_a, gi)
    return _launch("strsim_probe_multiset_blocked", ("multiset_blocked",), a, b, len_a,
                   a.element_size(), gi)


def multiset_blocked_plain(a, b, len_a, gi: int = 4) -> torch.Tensor:
    """The blocking changes the order of the compares, not the count."""
    if gi not in GROUPS:
        raise ValueError(f"gi {gi!r} not in {GROUPS}")
    return _by_compares(a, b, len_a)
