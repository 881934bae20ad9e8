"""The running top-k of jaro or jaro_winkler over queries against candidates.

`topk_scan` launches K23 (csrc/topk_scan.cu) on CUDA tensors: each query
against every candidate, the top k by (score descending, candidate index
ascending) kept on the device, exact float64 scores. `topk_plain` is the same
function in plain torch, tile by tile, on any device: the CPU's route, and
on the card the route of rows K23 does not take (longer than MAX_LEN, k
above MAX_K, an alphabet above MAX_ALPHABET). Both score a pair as
polars-strsim does (strsim.rs:128-271): both empty 1.0, one side empty 0.0,
else the greedy jaro statistics (`jaro_cuda.jaro_plain`) finished as
`ops/finalize.py` finishes them, in its order of operations.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from strsim_tpu_torch.ops import _build
from strsim_tpu_torch.ops.jaro_cuda import jaro_plain

MAX_LEN = 32          # K23's longest query or candidate (one 32-bit word)
MAX_K = 8             # K23's largest k
MAX_ALPHABET = 253    # K23's most distinct candidate chars (byte indices)
THREADS = 640         # K23's queries a block (csrc/topk_scan.cu: kTopkThreads)
CAND_PAD = 0xFE       # past a candidate's length in its index row
PAIRS_A_TILE = 1 << 16  # the plain route's pairs a step


def candidate_indices(codes: np.ndarray, lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(alphabet, index rows) of candidate tiles for K23: the sorted distinct
    chars of the rows (int32), and each row's chars as indices into it,
    [n, MAX_LEN] uint8, CAND_PAD past the row's length. Rows of at most
    MAX_LEN chars."""
    w = min(codes.shape[1], MAX_LEN)
    chars = codes[:, :w].astype(np.int32)
    inside = np.arange(w)[None, :] < lengths[:, None]
    alphabet = np.unique(chars[inside]).astype(np.int32)
    rows = np.full((codes.shape[0], MAX_LEN), CAND_PAD, dtype=np.uint8)
    rows[:, :w] = np.where(inside, np.searchsorted(alphabet, chars), CAND_PAD)
    return alphabet, rows


def max_tile(alphabet_size: int, threads: int = 0) -> int:
    """The most candidates one of K23's shared-memory tiles holds."""
    return int(_build.library("topk_scan").strsim_topk_max_tile(alphabet_size, threads))


def topk_scan(q_codes, q_len, q_rows, c_idx, c_len, c_ids, alphabet, k: int, out_idx, out_score,
              winkler: bool = True, tile: int = 0, threads: int = 0,
              greedy_pairs: Optional[torch.Tensor] = None) -> None:
    """One K23 launch: for each query row q_rows[r] (int64) of q_codes ([Q,
    W] int8/int32, rows contiguous; q_len [Q] int32, at most MAX_LEN at
    those rows) its k <= MAX_K best candidates of c_idx ([C, MAX_LEN] uint8
    from `candidate_indices`; c_len [C] int32; c_ids [C] int32, what a
    candidate's slot reports) by (score descending, candidate index
    ascending) go to out_idx[row] (int64 [Q, k]) and out_score[row] (float64
    [Q, k]); slots with no candidate keep what the caller put there. tile:
    the most candidates a shared-memory tile (0: as many as fit); threads:
    a block's (0: THREADS); greedy_pairs: None, or an int64 [1] tensor on
    the device that the launch adds its count of pairs that ran the greedy
    match to (the rest its screen or the empty-row rule decided). Launch
    count "topk_scan"."""
    n, nc = q_rows.shape[0], c_idx.shape[0]
    if n == 0 or nc == 0:
        return
    if q_codes.dtype not in (torch.int8, torch.int32) or q_codes.stride(1) != 1:
        raise ValueError(f"q_codes must be int8/int32 rows, got {q_codes.dtype} {q_codes.stride()}")
    if c_idx.dtype != torch.uint8 or c_idx.shape[1] != MAX_LEN or not c_idx.is_contiguous():
        raise ValueError(f"c_idx must be contiguous uint8 [C, {MAX_LEN}], got {tuple(c_idx.shape)}")
    for name, t, dtype in (("q_len", q_len, torch.int32), ("q_rows", q_rows, torch.int64),
                           ("c_len", c_len, torch.int32), ("c_ids", c_ids, torch.int32),
                           ("alphabet", alphabet, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype}")
    if not 1 <= k <= MAX_K or out_idx.shape != (q_codes.shape[0], k):
        raise ValueError(f"k = {k} and outputs {tuple(out_idx.shape)}: k in 1..{MAX_K}, [Q, k]")
    if alphabet.numel() > MAX_ALPHABET:
        raise ValueError(f"{alphabet.numel()} candidate chars: K23 takes {MAX_ALPHABET} at most")
    if greedy_pairs is not None and (greedy_pairs.dtype != torch.int64 or greedy_pairs.numel() != 1
                                     or greedy_pairs.device != q_codes.device):
        raise ValueError(f"greedy_pairs must be one int64 on {q_codes.device}")
    _build.call("topk_scan", "strsim_topk_scan", ("topk_scan",), q_codes.device,
                q_codes.data_ptr(), q_codes.stride(0), q_len.data_ptr(), q_rows.data_ptr(), n,
                c_idx.data_ptr(), c_len.data_ptr(), c_ids.data_ptr(), nc, alphabet.data_ptr(),
                alphabet.numel(), tile, k, int(winkler), threads, out_idx.data_ptr(),
                out_score.data_ptr(), None if greedy_pairs is None else greedy_pairs.data_ptr(),
                q_codes.element_size())


def finish_scores(m, t, prefix, la, lb, winkler: bool = True):
    """Float64 scores from the jaro statistics, as ops/finalize.py's
    finalize_jaro(_winkler) computes them (the host's bits), with the row
    conventions: both empty 1.0, one side empty 0.0."""
    dtype = torch.float64
    mf = m.to(dtype)
    safe = m.clamp(min=1).to(dtype)
    # every quotient tensor by tensor: on a CUDA tensor, torch divides by a
    # Python number as a multiplication by its reciprocal, which is not the
    # correctly rounded quotient (x / 3.0 one ulp off, and jaro at 0.7 then
    # misses the winkler boost)
    js = (mf / la.clamp(min=1).to(dtype) + mf / lb.clamp(min=1).to(dtype)
          + (m - t // 2).to(dtype) / safe) / torch.full_like(mf, 3.0)
    js = torch.where(m == 0, torch.zeros_like(js), js)
    if winkler:
        js = torch.where(js > 0.7, js + ((prefix.to(dtype) * 0.1) * (1.0 - js)), js)
    js = torch.where((la == 0) | (lb == 0), torch.zeros_like(js), js)
    return torch.where((la == 0) & (lb == 0), torch.ones_like(js), js)


def _pad(codes, width: int, pad: int):
    if codes.shape[1] >= width:
        return codes[:, :width]
    out = torch.full((codes.shape[0], width), pad, dtype=codes.dtype, device=codes.device)
    out[:, : codes.shape[1]] = codes
    return out


def pair_scores(q_codes, q_len, c_codes, c_len, winkler: bool = True):
    """[nq, nc] scores of every query row against every candidate row, in
    plain torch: the pairs materialised, `jaro_plain` with the prefix, then
    `finish_scores`. Pads: -1 on the query side, -2 on the candidate's."""
    nq, nc = q_codes.shape[0], c_codes.shape[0]
    wq = max(int(q_len.max()) if nq else 0, 1)
    wc = max(int(c_len.max()) if nc else 0, 1)
    width = max(wq, wc)
    dtype_codes = torch.int32 if q_codes.dtype != c_codes.dtype else q_codes.dtype
    a = _pad(q_codes[:, :wq].to(dtype_codes), width, -1).repeat_interleave(nc, 0)
    b = _pad(c_codes[:, :wc].to(dtype_codes), width, -2).repeat(nq, 1)
    la = q_len.to(torch.int32).repeat_interleave(nc)
    lb = c_len.to(torch.int32).repeat(nq)
    m, t, prefix = jaro_plain(a, b, la, lb, with_prefix=True)
    return finish_scores(m, t, prefix, la, lb, winkler).reshape(nq, nc)


def none_to_neg_inf(scores):
    """NaN (no candidate) as -inf, the rank's lowest score."""
    return torch.where(torch.isnan(scores), torch.full_like(scores, float("-inf")), scores)


def rank(scores, ids, k: int):
    """The first k of each row by (score descending, id ascending): scores
    [n, w] float (-inf or NaN: no candidate), ids [n, w] int64. Returns
    ([n, k] ids, -1 where none; [n, k] scores, -inf where none), padded to
    k. Two stable sorts: by id, then by score."""
    scores = none_to_neg_inf(scores)
    order = torch.argsort(ids, dim=1, stable=True)
    scores, ids = scores.gather(1, order), ids.gather(1, order)
    order = torch.argsort(-scores, dim=1, stable=True)[:, :k]
    scores, ids = scores.gather(1, order), ids.gather(1, order)
    ids = torch.where(torch.isinf(scores), torch.full_like(ids, -1), ids)
    if scores.shape[1] < k:
        n, short = scores.shape[0], k - scores.shape[1]
        scores = torch.cat([scores, scores.new_full((n, short), float("-inf"))], 1)
        ids = torch.cat([ids, ids.new_full((n, short), -1)], 1)
    return ids, scores


def tiled_topk(score, nq: int, c_ids, k: int, candidate_block: Optional[int] = None,
               best: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The running top k of nq queries against the candidates c_ids ([nc]
    int64, ascending ids being the tie rule's order), a query tile against
    a candidate tile at a time: score(query slice, candidate slice) gives
    their [q tile, c tile] float64 scores (NaN: no candidate), merged by
    `rank` into `best` (ids, scores), the running top k. Returns ([nq, k]
    ids, [nq, k] scores, -inf where none) on c_ids' device."""
    nc = c_ids.shape[0]
    if best is None:
        best = (torch.full((nq, k), -1, dtype=torch.int64, device=c_ids.device),
                torch.full((nq, k), float("-inf"), dtype=torch.float64, device=c_ids.device))
    ct = max(1, min(nc, candidate_block or 1024))
    qt = max(1, PAIRS_A_TILE // ct)
    ids_out, s_out = [], []
    for q0 in range(0, nq, qt):
        rows = slice(q0, q0 + qt)
        ids, s = best[0][rows], best[1][rows]
        for c0 in range(0, nc, ct):
            cols = slice(c0, c0 + ct)
            new = score(rows, cols)
            new_ids = c_ids[cols].to(torch.int64).expand(new.shape[0], -1)
            ids, s = rank(torch.cat([s, new], 1), torch.cat([ids, new_ids], 1), k)
        ids_out.append(ids)
        s_out.append(s)
    if not ids_out:
        return best
    return torch.cat(ids_out), torch.cat(s_out)


def topk_plain(q_codes, q_len, c_codes, c_len, c_ids, k: int, winkler: bool = True,
               candidate_block: Optional[int] = None,
               best: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """K23's function in plain torch (`tiled_topk` over `pair_scores`):
    ([nq, k] ids, [nq, k] scores, -inf where none) of each query row
    against the candidate rows (c_ids [nc] int64 their ids), `best` the
    running top k to merge into."""
    def score(rows, cols):
        return pair_scores(q_codes[rows], q_len[rows], c_codes[cols], c_len[cols], winkler)
    return tiled_topk(score, q_codes.shape[0], c_ids, k, candidate_block, best)
