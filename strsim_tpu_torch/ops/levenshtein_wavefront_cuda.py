"""Levenshtein distance by the full dynamic program (K10).

The counterpart of `strsim_tpu/ops/levenshtein_pallas.py:
levenshtein_distance_pallas`, which only a forced `levenshtein_impl="pallas"`
reaches. `levenshtein_distance` launches the hand-written CUDA kernel
(csrc/levenshtein_wavefront.cu) on CUDA tiles and runs `wavefront_plain` on
CPU tiles. `wavefront_plain` is `strsim_tpu/ops/stats.py:levenshtein_distance`
in plain torch: the anti-diagonal wavefront over [B, L + 1] state.

Contract (both forms, every row): with D[i][j] the edit distance of a[:i] and
b[:j], the result is D[la][lb] where la + lb >= 2 and 0 where la + lb <= 1
(the wavefront's first diagonal that can capture is d = 2). The pipeline never
sends a row with an empty side, and the finalizer ignores such rows. A row
whose lengths are not in 0..L gives 0.
"""
from __future__ import annotations

import torch

from strsim_tpu_torch.ops import _build
from strsim_tpu_torch.utils.encode import PAD_A, PAD_B

MAX_WIDTH = 512
_DTYPES = (torch.int8, torch.int32)


def supports_width(width: int) -> bool:
    return width <= MAX_WIDTH


def levenshtein_distance(a, b, len_a, len_b) -> torch.Tensor:
    """[B] int32 distances; a, b: [B, L] int8/int32 tiles (rows may be column
    slices of a packed tile), len_a, len_b: [B] int32, L <= 512."""
    if not _build.check_tiles(a, b, len_a, len_b, MAX_WIDTH, _DTYPES):
        return wavefront_plain(a, b, len_a, len_b)
    out = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    _build.launch("levenshtein_wavefront", "strsim_levenshtein_wavefront",
                  ("levenshtein_wavefront",), a, b, len_a, len_b, (out,), a.element_size())
    return out


def wavefront_plain(a, b, len_a, len_b) -> torch.Tensor:
    """Plain torch wavefront on any device. Lane i of diagonal d holds
    D[i][d - i]; a step is a min over the two previous diagonals, shifted.
    Lanes past a row's lengths hold values that only overestimate and never
    reach the captured cell (i = la at d = la + lb)."""
    n, width = a.shape
    dev = a.device
    big = 2 * width + 5
    la, lb = len_a.long(), len_b.long()
    in_range = (la >= 0) & (lb >= 0) & (la <= width) & (lb <= width)
    target = torch.where(in_range, la + lb, -1)
    # lane i compares a[i - 1]; lane 0 is the boundary column
    a_sh = torch.cat([torch.full((n, 1), PAD_A, dtype=torch.int32, device=dev),
                      a.to(torch.int32)], dim=1)
    # diagonal d, lane i needs b[d - i - 1] = ext[2L - d + i]
    pad = torch.full((n, width), PAD_B, dtype=torch.int32, device=dev)
    ext = torch.cat([pad, b.to(torch.int32).flip(1), pad], dim=1)
    ii = torch.arange(width + 1, device=dev)
    at_la = ii[None, :] == la[:, None]
    prev2 = torch.where(ii == 0, 0, big).to(torch.int32).expand(n, -1)  # diagonal 0
    prev = torch.where(ii <= 1, 1, big).to(torch.int32).expand(n, -1)   # diagonal 1
    big_col = torch.full((n, 1), big, dtype=torch.int32, device=dev)
    acc = torch.zeros(n, dtype=torch.int32, device=dev)
    d_max = int(target.max()) if n else 0
    for d in range(2, d_max + 1):
        cost = (a_sh != ext[:, 2 * width - d : 3 * width - d + 1]).to(torch.int32)
        new = torch.minimum(
            torch.minimum(torch.cat([big_col, prev[:, :-1]], 1) + 1, prev + 1),
            torch.cat([big_col, prev2[:, :-1]], 1) + cost,
        )
        acc += torch.where((target == d)[:, None] & at_la, new, 0).sum(1, dtype=torch.int32)
        prev2, prev = prev, new
    return acc
