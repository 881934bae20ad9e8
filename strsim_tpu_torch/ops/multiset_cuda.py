"""Character-multiset intersection sum_c min(cnt_a(c), cnt_b(c)) per row.

Two kernels, each with its plain torch version beside it:

* `multiset_intersection_rank` (csrc/multiset.cu: strsim_multiset_rank),
  widths <= 64, any codepoint: position i < la counts iff its occurrence
  rank among equal chars of a is below that char's count in b[:lb]. Plain
  form: `rank_plain`, the counterpart of
  `strsim_tpu/ops/multiset_loop.py:multiset_intersection_chunked`; the
  pipeline also uses it on CUDA for wide int32 and extend buckets.
* `multiset_intersection_hist` (strsim_multiset_hist), 8-bit tiles of any
  width up to 512: a 128-bin histogram of a[:la] consumed by b[:lb]. Plain
  form: `hist_plain`.

The two forms of each kernel agree on every row; both read the lengths, so
padded rows (la = lb = 0) give 0.
"""
from __future__ import annotations

import torch

from strsim_tpu_torch.ops import _build

RANK_MAX_WIDTH = 64
HIST_MAX_WIDTH = 512
_CHUNK = 16  # a-positions per fused [B, chunk, L] compare in rank_plain


def multiset_intersection_rank(a, b, len_a, len_b) -> torch.Tensor:
    """[B] int32; a, b: [B, L] int8/int32 tiles, len_a, len_b: [B] int32,
    L <= 64."""
    if not _build.check_tiles(a, b, len_a, len_b, RANK_MAX_WIDTH, (torch.int8, torch.int32)):
        return rank_plain(a, b, len_a, len_b)
    return _launch("multiset_rank", a, b, len_a, len_b, a.element_size())


def multiset_intersection_hist(a, b, len_a, len_b) -> torch.Tensor:
    """[B] int32; a, b: [B, L] int8 tiles (codepoints < 128), len_a, len_b:
    [B] int32, L <= 512."""
    if not _build.check_tiles(a, b, len_a, len_b, HIST_MAX_WIDTH, (torch.int8,)):
        return hist_plain(a, b, len_a, len_b)
    return _launch("multiset_hist", a, b, len_a, len_b)


def _launch(kernel: str, a, b, len_a, len_b, *elem_bytes) -> torch.Tensor:
    out = torch.empty(a.shape[0], dtype=torch.int32, device=a.device)
    _build.launch("multiset", f"strsim_{kernel}", (kernel,), a, b, len_a, len_b,
                  (out,), *elem_bytes)
    return out


def rank_plain(a, b, len_a, len_b) -> torch.Tensor:
    """Plain torch occurrence-rank intersection on any device, _CHUNK
    a-positions per fused compare-reduce."""
    n, width = a.shape
    dev = a.device
    la = len_a.long()
    b_valid = torch.arange(width, device=dev)[None, :] < len_b.long()[:, None]
    kk = torch.arange(width, device=dev)
    inter = torch.zeros(n, dtype=torch.int64, device=dev)
    steps = int(torch.clamp(la, 0, width).max()) if n else 0
    for i0 in range(0, steps, _CHUNK):
        ii = torch.arange(i0, min(i0 + _CHUNK, width), device=dev)
        ai = a[:, i0 : i0 + ii.numel(), None]  # [B, G, 1]
        cnt_b = ((ai == b[:, None, :]) & b_valid[:, None, :]).sum(2)
        before = kk[None, :] < ii[:, None]  # [G, L]: k strictly before i
        occ = ((ai == a[:, None, :]) & before[None]).sum(2)
        inter += ((occ < cnt_b) & (ii[None, :] < la[:, None])).sum(1)
    return inter.to(torch.int32)


def hist_plain(a, b, len_a, len_b) -> torch.Tensor:
    """Plain torch 128-bin histogram intersection for 8-bit tiles."""
    n, width = a.shape
    jj = torch.arange(width, device=a.device)[None, :]

    def counts(x, lengths):
        keep = (jj < lengths.long()[:, None]) & (x >= 0)
        bins = torch.zeros((n, 128), dtype=torch.int32, device=a.device)
        return bins.scatter_add_(1, x.long().clamp(min=0), keep.to(torch.int32))

    return torch.minimum(counts(a, len_a), counts(b, len_b)).sum(1).to(torch.int32)
