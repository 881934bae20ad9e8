"""Record linkage: the k best candidates of each query, one string column of
queries against a column of candidates. The counterpart of
`strsim_tpu/models/linkage.py:top_k_matches` (RapidFuzz's
`process.extract(query, choices, scorer=..., limit=k)` over a column):

  1. encode both columns (utils/encode.py, native/);
  2. order the non-null queries by length (`native/binding.py:order_rows`,
     the pairs pipeline's ladder), so that neighbouring queries take the
     same number of greedy steps;
  3. jaro and jaro_winkler on the card: K23 (csrc/topk_scan.cu,
     ops/topk_cuda.py) screens every query against every candidate with the
     candidates in shared-memory tiles, runs the greedy match on the pairs
     that could enter a top k, keeps each query's top k on the device, with
     exact float64 scores, and writes each query's row of the result in
     place; rows K23 does not take (longer than
     `topk_cuda.MAX_LEN`, k above `topk_cuda.MAX_K`, more candidate chars
     than `topk_cuda.MAX_ALPHABET`) take the plain torch route on the
     device, tile by tile, with the same scores, merge and tie rule;
  4. download [Q, k]; the plain route's rows go back to query order.

On the CPU (`StrsimConfig(device="cpu")`) jaro and jaro_winkler take the
plain torch route; the other measures take a tiled route over the pairs
pipeline (`compute_scores` on query-tile x candidate-tile pairs, the same
merge): correct, not fast.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from strsim_tpu_torch.config import StrsimConfig, get_config
from strsim_tpu_torch.models import pipeline
from strsim_tpu_torch.models.measures import resolve_measures
from strsim_tpu_torch.native import binding as nb
from strsim_tpu_torch.ops import topk_cuda
from strsim_tpu_torch.utils import encode as enc
from strsim_tpu_torch.utils.encode import EncodedColumn
from strsim_tpu_torch.utils.metrics import maybe_span

JARO_FAMILY = {"jaro": False, "jaro_winkler": True}  # measure -> the winkler boost


def top_k_matches(
    queries,
    candidates,
    measure: str = "jaro_winkler",
    k: int = 5,
    config: Optional[StrsimConfig] = None,
    metrics=None,
    candidate_block: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(indices [Q, k] int64, scores [Q, k] float64): for each query, the
    indices of its k best candidates in descending score, and their scores.
    A null query gets -1 / NaN; a null candidate never matches; with fewer
    than k candidates the trailing columns are -1 / NaN (the output is
    always k wide); Q = 0, C = 0 or k <= 0 give an empty or padded result.
    Each pair follows polars-strsim's row conventions: equal strings, or
    both empty, score 1.0, exactly one side empty 0.0.

    Departures from `strsim_tpu`'s top_k_matches:
      * scores are float64, identical to compute(measure, q, c) for every
        pair returned (strsim_tpu: float32, from its device finalizers);
      * ties: equal scores rank by the lower candidate index, as RapidFuzz's
        extract orders them (strsim_tpu leaves the order to lax.top_k).

    `candidate_block`: the most candidates a tile (K23's shared-memory tile,
    the plain route's); None: as many as K23's shared memory holds, 1,024 on
    the plain route. `metrics`: a utils.metrics.RunMetrics for the call's
    spans ("strsim.topk" and its parts) and counters ("topk.pairs",
    "topk.lane_pairs", "topk.launches", and where K23 ran,
    "topk.greedy_pairs": the pairs it ran the greedy match for, read back
    from the device)."""
    cfg = config or get_config()
    device = pipeline._device(cfg)
    (measure,) = resolve_measures(measure)
    if metrics is not None:
        metrics.calls += 1
    with maybe_span(metrics, "strsim.topk"):
        with maybe_span(metrics, "strsim.topk.encode"):
            q = enc.encode_column(queries, pad=enc.PAD_A)
            c = enc.encode_column(candidates, pad=enc.PAD_B)
        kk = max(k, 0)
        if q.n == 0 or c.n == 0 or kk == 0:
            return (np.full((q.n, kk), -1, dtype=np.int64),
                    np.full((q.n, kk), np.nan, dtype=np.float64))
        with maybe_span(metrics, "strsim.topk.stage"):
            plan = _stage(q, c, measure, kk, cfg, device)
        greedy = None
        with maybe_span(metrics, "strsim.topk.launch"):
            if plan["k23"] is not None:
                if metrics is not None:
                    greedy = torch.zeros(1, dtype=torch.int64, device=device)
                topk_cuda.topk_scan(**plan["k23"], k=kk, out_idx=plan["idx"],
                                    out_score=plan["score"], winkler=JARO_FAMILY[measure],
                                    tile=candidate_block or 0, greedy_pairs=greedy)
                _count(metrics, plan["pairs"], plan["lane_pairs"], 1)
        pending = []
        if plan["rest"]:
            with maybe_span(metrics, "strsim.topk.plain"):
                for q_rows, c_pos, merge in plan["rest"]:
                    pending.append((q_rows, *_rest(q, c, plan, q_rows, c_pos, merge, measure, kk,
                                                   cfg, candidate_block)))
                    _count(metrics, q_rows.size * c_pos.size, q_rows.size * c_pos.size, 0)
        with maybe_span(metrics, "strsim.topk.collect"):
            # waits for the device; [Q, k], rows in query order
            idx, score = download(plan["idx"]), download(plan["score"])
            if greedy is not None:
                metrics.count("topk.greedy_pairs", int(greedy.item()))
        with maybe_span(metrics, "strsim.topk.finish"):
            for q_rows, ids, scores in pending:
                to_query_order(idx, score, q_rows, ids, scores)
    return idx, score


def _count(metrics, pairs: int, lane_pairs: int, launches: int) -> None:
    if metrics is not None:
        metrics.count("topk.pairs", pairs)
        metrics.count("topk.lane_pairs", lane_pairs)
        metrics.count("topk.launches", launches)


def download(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array: on a CUDA device through page-locked
    memory (a DMA copy, several times the pageable copy's rate), the array a
    view of it; a CPU tensor's own memory."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def order_queries(q: EncodedColumn, cfg: StrsimConfig) -> np.ndarray:
    """The non-null query rows (int64) ordered by length on the ladder: one
    native stable counting pass (`binding.order_rows`, as the pairs
    pipeline's `bucket_rows` orders its rows), ties in row order. A null
    row's length is 0."""
    rows = np.arange(q.n, dtype=np.int64) if q.validity.all() else np.nonzero(q.validity)[0]
    widths, rank_of = pipeline._ladder(cfg)
    return nb.order_rows(rows, q.lengths, np.zeros(q.n, dtype=np.int32), rank_of, widths.size)[0]


def to_query_order(idx: np.ndarray, score: np.ndarray, q_rows: np.ndarray, ids, scores) -> None:
    """Rows of a result in query order: row r of (ids, scores), the result
    of query q_rows[r], goes to row q_rows[r] of (idx, score); -inf (no
    candidate) becomes NaN."""
    scores = scores.cpu().numpy()
    idx[q_rows] = ids.cpu().numpy()
    score[q_rows] = np.where(np.isinf(scores), np.nan, scores)


def _stage(q: EncodedColumn, c: EncodedColumn, measure: str, k: int, cfg: StrsimConfig,
           device: torch.device) -> dict:
    """The call's plan: the output buffers on `device` (-1 / NaN), K23's
    arguments uploaded where K23 takes rows ("k23"), its pair counts, and
    the rest: (query rows, candidate rows, merge with K23's result) for the
    plain or tiled route."""
    order = order_queries(q, cfg)
    c_rows = np.nonzero(c.validity)[0].astype(np.int64)
    plan = {"idx": torch.full((q.n, k), -1, dtype=torch.int64, device=device),
            "score": torch.full((q.n, k), float("nan"), dtype=torch.float64, device=device),
            "rest": [], "k23": None, "device": device}
    if not order.size or not c_rows.size:
        return plan
    narrow_q = order  # every row narrow when the widest is
    if q.width > topk_cuda.MAX_LEN:
        narrow_q = order[q.lengths[order] <= topk_cuda.MAX_LEN]
    narrow_c = c_rows[c.lengths[c_rows] <= topk_cuda.MAX_LEN]
    k23 = (device.type == "cuda" and measure in JARO_FAMILY and k <= topk_cuda.MAX_K
           and narrow_q.size and narrow_c.size)
    if k23:
        alphabet, c_idx = topk_cuda.candidate_indices(c.codes[narrow_c], c.lengths[narrow_c])
        k23 = alphabet.size <= topk_cuda.MAX_ALPHABET
    if not k23:
        plan["rest"].append((order, c_rows, False))
        return plan
    plan["k23"] = {
        "q_codes": torch.from_numpy(q.codes).to(device),
        "q_len": torch.from_numpy(q.lengths).to(device),
        "q_rows": torch.from_numpy(narrow_q).to(device),
        "c_idx": torch.from_numpy(c_idx).to(device),
        "c_len": torch.from_numpy(c.lengths[narrow_c]).to(device),
        "c_ids": torch.from_numpy(narrow_c.astype(np.int32)).to(device),
        "alphabet": torch.from_numpy(alphabet).to(device),
    }
    plan["pairs"] = narrow_q.size * narrow_c.size
    blocks = -(-narrow_q.size // topk_cuda.THREADS)
    plan["lane_pairs"] = blocks * topk_cuda.THREADS * narrow_c.size
    wide_c = c_rows[c.lengths[c_rows] > topk_cuda.MAX_LEN]
    if wide_c.size:  # narrow queries against the wide candidates, merged with K23's
        plan["rest"].append((narrow_q, wide_c, True))
    wide_q = order[q.lengths[order] > topk_cuda.MAX_LEN]
    if wide_q.size:
        plan["rest"].append((wide_q, c_rows, False))
    return plan


def _rest(q, c, plan, q_rows, c_rows, merge: bool, measure, k, cfg, candidate_block):
    """The plain (jaro family) or tiled (other measures) route's result for
    query rows `q_rows` against candidate rows `c_rows`: ([n, k] ids, [n, k]
    scores, -inf where none) on the output's device, merged with what K23
    wrote for those queries where `merge`."""
    device = plan["device"]
    best = None
    if merge:
        rows = torch.from_numpy(q_rows).to(device)
        best = (plan["idx"][rows], topk_cuda.none_to_neg_inf(plan["score"][rows]))
    if measure not in JARO_FAMILY:  # never K23's, so never merged
        return _pipeline_topk(q, c, q_rows, c_rows, measure, k, cfg, candidate_block)
    k23 = plan["k23"]
    codes = k23["q_codes"] if k23 else torch.from_numpy(q.codes).to(device)
    lens = k23["q_len"] if k23 else torch.from_numpy(q.lengths).to(device)
    rows = torch.from_numpy(q_rows).to(device)
    return topk_cuda.topk_plain(
        codes[rows], lens[rows], torch.from_numpy(c.codes[c_rows]).to(device),
        torch.from_numpy(c.lengths[c_rows]).to(device), torch.from_numpy(c_rows).to(device), k,
        JARO_FAMILY[measure], candidate_block, best=best)


def _pipeline_topk(q, c, q_rows, c_rows, measure, k, cfg, candidate_block):
    """The tiled route of a measure without a top-k kernel: each query tile
    against each candidate tile as paired columns through the pairs
    pipeline (`compute_scores`), merged tile by tile (`topk_cuda.tiled_topk`)."""
    def score(rows, cols):
        qr, cr = q_rows[rows], c_rows[cols]
        ones = np.ones(qr.size * cr.size, dtype=bool)
        a = EncodedColumn(codes=np.repeat(q.codes[qr], cr.size, axis=0),
                          lengths=np.repeat(q.lengths[qr], cr.size), validity=ones)
        b = EncodedColumn(codes=np.tile(c.codes[cr], (qr.size, 1)),
                          lengths=np.tile(c.lengths[cr], qr.size), validity=ones)
        new = pipeline.compute_scores(a, b, (measure,), config=cfg)[measure][0]
        return torch.from_numpy(new).reshape(qr.size, cr.size)
    return topk_cuda.tiled_topk(score, q_rows.size, torch.from_numpy(c_rows), k, candidate_block)
