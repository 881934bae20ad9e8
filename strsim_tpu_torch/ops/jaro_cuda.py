"""Jaro match statistics (m, t): greedy windowed match and transpositions,
and, when asked, the common prefix that jaro_winkler reads.

`jaro_match_stats` launches the hand-written CUDA kernel (csrc/jaro_scan.cu,
its kernel in csrc/jaro_body.cuh) on CUDA tiles and runs `jaro_plain` on CPU
tiles; `with_prefix=True` adds the prefix to the same launch (the plain form:
`stats.shared_prefix_length`). `jaro_plain` is the greedy
scan in plain torch, the counterpart of
`strsim_tpu/ops/jaro_bitmask.py:jaro_match_stats_bitmask`; the pipeline also
uses it on CUDA for extend buckets wider than the kernel's 512. Its parts,
`greedy_scan`, `transposition_count` and `patch_one_one`, also serve K9
(`ops/jaro_flags_cuda.py`).

Contract (both forms, every row; reference strsim.rs:197-243): bound =
max(la, lb) // 2 - 1; a-positions i < min(la, lb + bound) in order each flag
the first unflagged b-position j with b_j == a_i in
[max(i - bound, 0), min(i + bound, lb - 1)]; m counts the flags; t counts the
ranks where the r-th matched a char differs from the r-th flagged b char (raw,
before the finalizer's t // 2). la == lb == 1 gives m = (a_0 == b_0), t = 0.
Exact for every codepoint on int8 and int32 tiles.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from strsim_tpu_torch.ops import _build

MAX_WIDTH = 512
_DTYPES = (torch.int8, torch.int32)


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def jaro_match_stats(a, b, len_a, len_b, with_prefix: bool = False) -> Tuple[torch.Tensor, ...]:
    """([B] m, [B] t), or (m, t, prefix) with `with_prefix`, int32; a, b:
    [B, L] int8/int32 tiles (rows may be column slices of a packed tile),
    len_a, len_b: [B] int32, L <= 512. Launch counts: "jaro_scan", and
    "jaro_scan.prefix" with the prefix."""
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return jaro_plain(a, b, len_a, len_b, with_prefix)
    m = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    t = torch.empty_like(m)
    prefix = torch.empty_like(m) if with_prefix else None
    _build.launch("jaro_scan", "strsim_jaro_scan",
                  ("jaro_scan", "jaro_scan.prefix") if with_prefix else ("jaro_scan",),
                  a, b, len_a, len_b, (m, t, prefix), a.element_size())
    return (m, t, prefix) if with_prefix else (m, t)


def residency(width: int, dtype: torch.dtype, with_prefix: bool = False) -> Dict[str, int]:
    """What the card gives K2's launch at this tile width and dtype: the
    blocks an SM holds (the occupancy calculator at the launch's dynamic
    shared memory), registers and local memory bytes a thread, and the
    dynamic shared memory a block."""
    import ctypes

    out = (ctypes.c_int * 4)()
    rc = _build.library("jaro_scan").strsim_jaro_scan_residency(
        width, torch.empty((), dtype=dtype).element_size(), int(with_prefix), out)
    if rc != 0:
        raise RuntimeError(f"strsim_jaro_scan_residency failed: cudaError_t {rc}")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "smem_bytes"), out))


def jaro_plain(a, b, len_a, len_b, with_prefix: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain torch (m, t) on any device: `greedy_scan`, `transposition_count`
    and the len-1/len-1 patch, the steps of
    strsim_tpu/ops/jaro_pallas.py:jaro_match_stats_pallas; with
    `with_prefix`, (m, t, stats.shared_prefix_length)."""
    m, matched, flagged = greedy_scan(a, b, len_a, len_b)
    t = transposition_count(a, b, matched, flagged)
    m, t = patch_one_one(a, b, len_a, len_b, m, t)
    if not with_prefix:
        return m, t
    from strsim_tpu_torch.ops.stats import shared_prefix_length  # stats imports this module

    return m, t, shared_prefix_length(a, b)


def greedy_scan(a, b, len_a, len_b) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The greedy match scan alone, one step per a-position over [B, L] flag
    tensors: ([B] int32 m, [B, L] bool matched_a, [B, L] bool flagged_b),
    what strsim_tpu/ops/jaro_pallas.py:_kernel emits. m counts the flags
    before any len-1/len-1 patch (those rows have an empty window: 0)."""
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
    return matched.sum(1, dtype=torch.int32), matched, flagged


def transposition_count(a, b, matched, flagged) -> torch.Tensor:
    """[B] int32 raw transpositions (strsim.rs:220-237): the ranks r where
    the r-th matched a char differs from the r-th flagged b char, the
    integers of strsim_tpu/ops/stats.py:transposition_count. Sorting the
    positions so that the flagged ones come first, in order, compacts each
    side by rank."""
    width = a.shape[1]
    jj = torch.arange(width, device=a.device)
    m = matched.sum(1)
    order_a = torch.sort(torch.where(matched, jj, jj + width), dim=1).indices
    order_b = torch.sort(torch.where(flagged, jj, jj + width), dim=1).indices
    differ = a.gather(1, order_a) != b.gather(1, order_b)
    return (differ & (jj[None, :] < m[:, None])).sum(1, dtype=torch.int32)


def patch_one_one(a, b, len_a, len_b, m, t) -> Tuple[torch.Tensor, torch.Tensor]:
    """len-1 against len-1 rows compare their chars directly
    (strsim.rs:197-199): m = (a_0 == b_0), t = 0; m, t as int32."""
    one_one = (len_a == 1) & (len_b == 1)
    m = torch.where(one_one, (a[:, 0] == b[:, 0]).to(torch.int32), m)
    t = torch.where(one_one, 0, t)
    return m.to(torch.int32), t.to(torch.int32)
