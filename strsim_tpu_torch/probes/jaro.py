"""Four A/B probes of the jaro scan (K2, `ops/jaro_cuda.py`), K12-K15.

Each is a hand-written CUDA kernel in `csrc/probe_jaro.cu` with its plain
torch version here, the counterpart of one TPU probe of `tools/`:

  K12 `jaro_flags_scan`  tools/ab_jaro_pallas.py `_scan_kernel` :59: the
      greedy scan alone at widths <= 32, writing m and the packed flag words
      `flagged` (b-positions) and `matched` (a-positions); `jaro_flags_probe`
      counts t outside it (`transpositions_from_words`) and applies the
      len-1/len-1 patch, as the probe's wrapper does (:143-146).
  K13 `packed_t_stats`   tools/ab_jaro_wide.py `_kernel_wide` :38: K2's scan,
      with t counted on rank slots of one byte a rank, four ranks a word;
      int8 tiles only (a byte a char is exact only there); `jaro_packed_t`
      applies the patch, as the probe's wrapper does (:144-147).
  K14 `jaro_clipped`     tools/ab_jaro_wide2.py `_kernel_wide_clipped` :56:
      K2, with a lane whose word lies outside the window union of its warp's
      rows (clip="warp"; the probe's block union) or outside its row's own
      window (clip="row") skipping its equality read and candidate step at
      that a-position; raw (m, t), no patch.
  K15 `jaro_ablated`     tools/ab_jaro_sol_probe.py `_ablated_kernel` :62:
      K2's body cut by `mode`: "full" (K2 without the patch), "no_tcount"
      (t = the popcount of a's matched words, which is m), "scan_only" (no
      matched words either; t = m) and "eqb_only" (only the equality words:
      m = t = the XOR of every equality word of every a-position i < L).

The JAX helpers the probes share (`strsim_tpu/ops/jaro_pallas_scan.py`):
`_satmask` is `lanes.cuh:ones_from`; `_pack_params` and
`_count_unequal_slots` are `_packed_t` below (K13's plain form) and
`packed_transpositions` in the kernel; `_wide_block_rows` and
`_block_rows_for` have no counterpart: the launch shape is the lane group's
(G lanes a row, G the word count rounded up to a power of two, 128 threads a
block), not a block of rows.

The wrappers launch their kernel on CUDA tiles (a build or launch failure
raises) and run the plain version on CPU tiles. Tiles follow
`ops/_build.py:check_tiles`. Launch counts: "jaro_flags_probe",
"jaro_packed_t", "jaro_clipped" (and "jaro_clipped.row"), "jaro_ablated"
and "jaro_ablated.<mode>".
"""
from __future__ import annotations

from typing import Tuple

import torch

from strsim_tpu_torch.ops import _build
from strsim_tpu_torch.ops.jaro_cuda import greedy_scan, patch_one_one, transposition_count

MAX_WIDTH = 512
FLAGS_MAX_WIDTH = 32  # K12: one flag word a row (G = 1), as the TPU probe
WIDE_MIN_WIDTH = 65  # K13 and K14: G = 4..16, the probes' wide widths
MODES = ("full", "no_tcount", "scan_only", "eqb_only")
CLIPS = ("warp", "row")
_DTYPES = (torch.int8, torch.int32)

Pair = Tuple[torch.Tensor, torch.Tensor]


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of the same bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """[B, L] bool -> [B, ceil(L / 32)] int32 words, bit k of word w the
    position 32w + k."""
    n, width = bits.shape
    words = -(-width // 32)
    padded = torch.zeros((n, 32 * words), dtype=torch.int64, device=bits.device)
    padded[:, :width] = bits.long()
    shifts = torch.arange(32, device=bits.device)
    return _to_int32((padded.view(n, words, 32) << shifts).sum(2))


def unpack_words(words: torch.Tensor, width: int) -> torch.Tensor:
    """[B] or [B, W] int32 words -> [B, width] bool (`pack_words` undone)."""
    w = words.reshape(words.shape[0], -1).long() & 0xFFFFFFFF
    shifts = torch.arange(32, device=words.device)
    return ((w[:, :, None] >> shifts) & 1).bool().reshape(w.shape[0], -1)[:, :width]


def transpositions_from_words(a, b, matched_words, flagged_words) -> torch.Tensor:
    """[B] int32 raw t from packed matched (a) and flagged (b) words, the
    counterpart of strsim_tpu/ops/jaro_bitmask.py:_transposition_from_masks:
    the bits unpacked to [B, L] bool, then `transposition_count`."""
    width = a.shape[1]
    return transposition_count(a, b, unpack_words(matched_words, width),
                               unpack_words(flagged_words, width))


# --- K12: the scan alone, flags packed ----------------------------------------

def jaro_flags_scan(a, b, len_a, len_b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """([B] m, [B] flagged, [B] matched) int32, m before the len-1/len-1
    patch; a, b: [B, L] int8/int32 tiles, L <= 32."""
    if not _build.check_tiles(a, b, len_a, len_b, FLAGS_MAX_WIDTH, _DTYPES):
        return jaro_flags_scan_plain(a, b, len_a, len_b)
    m, flagged, matched = (torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
                           for _ in range(3))
    _build.launch("probe_jaro", "strsim_probe_jaro_flags", ("jaro_flags_probe",),
                  a, b, len_a, len_b, (m, flagged, matched), a.element_size())
    return m, flagged, matched


def jaro_flags_scan_plain(a, b, len_a, len_b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`greedy_scan` with its bool tensors packed into one word a row."""
    m, matched, flagged = greedy_scan(a, b, len_a, len_b)
    return m, pack_words(flagged)[:, 0], pack_words(matched)[:, 0]


def jaro_flags_probe(a, b, len_a, len_b) -> Pair:
    """K12's arm of the A/B: the scan, t from its words in plain torch and
    the len-1/len-1 patch, as tools/ab_jaro_pallas.py's wrapper (:134-147)."""
    m, flagged, matched = jaro_flags_scan(a, b, len_a, len_b)
    t = transpositions_from_words(a, b, matched, flagged)
    return patch_one_one(a, b, len_a, len_b, m, t)


# --- K13: t on byte slots -----------------------------------------------------

def _check_wide(a) -> None:
    if a.dim() == 2 and not WIDE_MIN_WIDTH <= a.shape[1] <= MAX_WIDTH:
        raise ValueError(f"tile width {a.shape[1]} outside {WIDE_MIN_WIDTH}..{MAX_WIDTH}")


def packed_t_stats(a, b, len_a, len_b) -> Pair:
    """K13's raw ([B] m, [B] t) int32, before the len-1/len-1 patch; a, b:
    [B, L] int8 tiles, 65 <= L <= 512. int32 tiles raise TypeError: their
    chars do not fit a byte slot, so t would be wrong."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"jaro_packed_t takes int8 tiles only (a byte a char), got {a.dtype}")
    _check_wide(a)
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, (torch.int8,)):
        return packed_t_stats_plain(a, b, len_a, len_b)
    m = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    t = torch.empty_like(m)
    _build.launch("probe_jaro", "strsim_probe_jaro_packed_t", ("jaro_packed_t",),
                  a, b, len_a, len_b, (m, t), a.element_size())
    return m, t


def jaro_packed_t(a, b, len_a, len_b) -> Pair:
    """K13's arm of the A/B: `packed_t_stats` and the len-1/len-1 patch, as
    tools/ab_jaro_wide.py's wrapper (:141-147)."""
    return patch_one_one(a, b, len_a, len_b, *packed_t_stats(a, b, len_a, len_b))


def _packed_t(a, b, matched, flagged) -> torch.Tensor:
    """t by tools/ab_jaro_wide.py's method: each side's matched chars in
    rank order, one byte a rank, four ranks a 32-bit word (unwritten slots 0
    on both sides), XOR, count the nonzero bytes
    (strsim_tpu/ops/jaro_pallas_scan.py:_count_unequal_slots at pack = 4)."""
    n, width = a.shape
    jj = torch.arange(width, device=a.device)
    m = matched.sum(1)
    slots = 4 * -(-width // 4)

    def words(chars, flags):
        order = torch.sort(torch.where(flags, jj, jj + width), dim=1).indices
        seq = torch.where(jj[None, :] < m[:, None], chars.gather(1, order).long() & 0xFF, 0)
        seq = torch.nn.functional.pad(seq, (0, slots - width)).view(n, slots // 4, 4)
        return (seq << torch.tensor([0, 8, 16, 24], device=a.device)).sum(2)

    x = words(a, matched) ^ words(b, flagged)
    return sum((((x >> (8 * byte)) & 0xFF) != 0).sum(1, dtype=torch.int32) for byte in range(4))


def packed_t_stats_plain(a, b, len_a, len_b) -> Pair:
    """`greedy_scan`, then t by `_packed_t`; unpatched."""
    m, matched, flagged = greedy_scan(a, b, len_a, len_b)
    return m, _packed_t(a, b, matched, flagged)


def jaro_packed_t_plain(a, b, len_a, len_b) -> Pair:
    """`packed_t_stats_plain` and the len-1/len-1 patch."""
    return patch_one_one(a, b, len_a, len_b, *packed_t_stats_plain(a, b, len_a, len_b))


# --- K14: words outside the window skipped ------------------------------------

def jaro_clipped(a, b, len_a, len_b, clip: str = "warp") -> Pair:
    """Raw ([B] m, [B] t) int32 (no len-1/len-1 patch); a, b: [B, L]
    int8/int32 tiles, 65 <= L <= 512. clip: "warp" (the window union of the
    warp's rows) or "row" (the row's own window)."""
    if clip not in CLIPS:
        raise ValueError(f"clip must be one of {CLIPS}, got {clip!r}")
    _check_wide(a)
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return jaro_clipped_plain(a, b, len_a, len_b, clip)
    m = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    t = torch.empty_like(m)
    counts = ("jaro_clipped",) + (("jaro_clipped.row",) if clip == "row" else ())
    _build.launch("probe_jaro", "strsim_probe_jaro_clipped", counts,
                  a, b, len_a, len_b, (m, t), a.element_size(), CLIPS.index(clip))
    return m, t


def jaro_clipped_plain(a, b, len_a, len_b, clip: str = "warp") -> Pair:
    """`greedy_scan` and `transposition_count`, unpatched: skipping dead
    words changes no result, so both clips have this one plain version."""
    if clip not in CLIPS:
        raise ValueError(f"clip must be one of {CLIPS}, got {clip!r}")
    m, matched, flagged = greedy_scan(a, b, len_a, len_b)
    return m, transposition_count(a, b, matched, flagged)


# --- K15: the production body, ablated ----------------------------------------

def jaro_ablated(a, b, len_a, len_b, mode: str = "full") -> Pair:
    """Raw ([B] m, [B] t) int32 of K2's body cut by `mode` (see the module
    docstring); a, b: [B, L] int8/int32 tiles, L <= 512."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return jaro_ablated_plain(a, b, len_a, len_b, mode)
    m = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    t = torch.empty_like(m)
    _build.launch("probe_jaro", "strsim_probe_jaro_ablated", ("jaro_ablated", f"jaro_ablated.{mode}"),
                  a, b, len_a, len_b, (m, t), a.element_size(), MODES.index(mode))
    return m, t


def equality_xor(a, b, len_b) -> torch.Tensor:
    """[B] int32: the XOR over every a-position i < L and every word of
    b's equality word for a_i, over b's chars j < min(lb, L). Bit k is the
    parity of the (i, j) pairs with a_i == b_j and j = k mod 32."""
    n, width = a.shape
    jj = torch.arange(width, device=a.device)
    count = torch.zeros((n, width), dtype=torch.int32, device=a.device)
    for i in range(width):
        count += a[:, i:i + 1] == b
    odd = (count & 1).bool() & (jj[None, :] < len_b.long()[:, None])
    lanes = torch.nn.functional.pad(odd, (0, 32 * -(-width // 32) - width)).view(n, -1, 32)
    return pack_words(lanes.sum(1) % 2 == 1)[:, 0]


def jaro_ablated_plain(a, b, len_a, len_b, mode: str = "full") -> Pair:
    """The four contracts: "full" `greedy_scan` and `transposition_count`
    (unpatched); "no_tcount" and "scan_only" m and t = m; "eqb_only" m = t =
    `equality_xor`."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "eqb_only":
        acc = equality_xor(a, b, len_b)
        return acc, acc.clone()
    m, matched, flagged = greedy_scan(a, b, len_a, len_b)
    if mode == "full":
        return m, transposition_count(a, b, matched, flagged)
    return m, m.clone()
