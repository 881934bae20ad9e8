"""End-to-end scoring pipeline: string columns -> bucketed device batches ->
scores. The counterpart of `strsim_tpu/models/pipeline.py:compute_scores`:

  1. validate shapes and broadcast a length-1 side (strsim.rs:48-52, 61-66);
  2. resolve null, both-empty, byte-equal and one-empty rows on the host;
  3. bucket the remaining rows by max(len_a, len_b) onto the ladder, each
     bucket ordered by la + lb (one native counting pass), narrow
     pure-ASCII buckets to int8, pad each to a size from the batch menu,
     pack it (native library) into a pinned staging buffer, upload it once
     without blocking and run the stat kernels (ops/stats.py) block by
     block;
  4. download the integer stats, finalize exact f64 scores on the host in the
     reference's order and scatter them back to row order (native library,
     or the numpy finalizers with native_finalize=False).

There is no fallback: a kernel or the native library that fails to build or
launch raises, and `device="cuda"` raises when no GPU is present. Rows
beyond the ladder (with overflow_policy="oracle" or past max_extend_len) and
inputs under `host_short_circuit_rows` are scored on the host by design, by
the native library's scalar kernels on every core (or the oracle, with
fallback="oracle").
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from strsim_tpu_torch.config import StrsimConfig, get_config
from strsim_tpu_torch.models.measures import MEASURES, resolve_measures
from strsim_tpu_torch.native import binding as nb
from strsim_tpu_torch.ops.stats import STAT_FIELDS, compute_stats, stat_routes
from strsim_tpu_torch.utils import encode as enc
from strsim_tpu_torch.utils.alloc import staging_empty
from strsim_tpu_torch.utils.encode import EncodedColumn
from strsim_tpu_torch.utils.metrics import maybe_span

_BATCH_MENU = (512, 4096, 16384, 32768, 65536)


def _round_batch(n: int, cfg: StrsimConfig) -> int:
    """Round a bucket batch up to a size from a small fixed menu, bounding the
    padded-row waste (the same menu as the JAX engine)."""
    for b in _BATCH_MENU:
        if n <= b and b <= cfg.max_batch_block:
            return b
    return cfg.max_batch_block


def _block_rows(width: int, cfg: StrsimConfig, measures: Tuple[str, ...], dtype) -> int:
    """Max rows per stat call, a power of two. The plain multiset and bigram
    forms (wide int32 and extend buckets, bigrams wider than 64, and any
    width under a forced XLA multiset or bigram value) hold a
    [rows, 16, L] compare tensor and the plain soundex a few [rows, L]
    tensors, so blocks that run one of them are capped at 2^28 / (16 L)
    rows; the kernels hold O(rows) state."""
    cap = cfg.max_batch_block
    routes = stat_routes(measures, width, _torch_dtype(dtype), cfg.impls())
    if any(routes.get(f) == "plain" for f in ("inter", "inter2", "sdx_eq")):
        cap = min(cap, max(cfg.min_batch, (1 << 28) // max(16 * width, 1)))
    b = cfg.min_batch
    while b * 2 <= cap:
        b *= 2
    return b


def _torch_dtype(dtype) -> torch.dtype:
    return torch.int8 if np.dtype(dtype) == np.int8 else torch.int32


def _stat_fields(measures: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(sorted({f for m in measures for f in STAT_FIELDS[m]}))


def _device(cfg: StrsimConfig) -> torch.device:
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"StrsimConfig.device={cfg.device!r} but no CUDA device is available; "
            "pass a config with device='cpu' to run the plain torch stats"
        )
    return device


def _broadcast_pair(
    a: EncodedColumn, b: EncodedColumn
) -> Tuple[EncodedColumn, EncodedColumn]:
    """Replicate a length-1 side to match the other (literal broadcast,
    strsim.rs:61-66). A null literal is an error (the reference panics on it,
    strsim.rs:62,65; this raises instead)."""
    if a.n == b.n:
        return a, b
    if b.n == 1:
        small, big, which = b, a, "b"
    elif a.n == 1:
        small, big, which = a, b, "a"
    else:
        raise ValueError(
            "Inputs must have the same length, or one of them must be a "
            f"length-1 literal (got {a.n} and {b.n})."
        )
    if not bool(small.validity[0]):
        raise ValueError(f"cannot broadcast a null literal (side {which!r})")
    rep = EncodedColumn(
        codes=np.broadcast_to(small.codes, (big.n, small.width)).copy(),
        lengths=np.broadcast_to(small.lengths, (big.n,)).copy(),
        validity=np.broadcast_to(small.validity, (big.n,)).copy(),
    )
    return (rep, big) if which == "a" else (big, rep)


def compute_scores(
    col_a,
    col_b,
    measures,
    config: Optional[StrsimConfig] = None,
    metrics=None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Score two string columns under every requested measure.

    Returns {measure: (values f64 [N], validity bool [N])}; values at invalid
    rows are NaN. Accepts lists / numpy arrays of str|None, anything with
    to_list, or a pair of EncodedColumns. Pass a utils.metrics.RunMetrics to
    collect occupancy, padding waste and the call's tree of spans
    ("strsim.call" and its parts, each named where its work happens).
    """
    cfg = config or get_config()
    device = _device(cfg)
    measures = resolve_measures(measures)
    if metrics is not None:
        metrics.calls += 1
    with maybe_span(metrics, "strsim.call"):
        with maybe_span(metrics, "strsim.encode"):
            if isinstance(col_a, EncodedColumn) and isinstance(col_b, EncodedColumn):
                a, b, route = col_a, col_b, "encoded"
                if a.width != b.width:
                    w = max(a.width, b.width)
                    a = enc._repad(a, enc.PAD_A, w)
                    b = enc._repad(b, enc.PAD_B, w)
            else:
                a, b, route = enc.encode_pair_with_route(col_a, col_b)
            a, b = _broadcast_pair(a, b)
        n = a.n
        if metrics is not None:
            metrics.n_rows += n
            metrics.encode_route = route

        with maybe_span(metrics, "strsim.classify"):
            validity, la, lb, trivial, one_empty, idx = classify(a, b, cfg)
            out = {m: np.full(n, np.nan, dtype=np.float64) for m in measures}
            for m in measures:
                out[m][trivial] = 1.0
                # one side empty: 0.0 for every measure (levenshtein's formula gives it too)
                out[m][one_empty] = 0.0
            if metrics is not None:
                metrics.null_rows += int(n - int(validity.sum()))
                metrics.fast_path_rows += int(trivial.sum())
                metrics.one_empty_rows += int(one_empty.sum())
                metrics.device_rows += int(idx.size)

        if idx.size and idx.size <= cfg.host_short_circuit_rows:
            # small input: the host scores it faster than a device round trip
            _host_rows(out, measures, a, b, idx, cfg, metrics)
            idx = idx[:0]

        with maybe_span(metrics, "strsim.partition"):
            buckets = bucket_rows(idx, la, lb, cfg)
        # dispatch every bucket first (uploads and kernels queue on the stream),
        # then collect and finalize in order
        pending = []
        for width, sel in buckets.items():
            if width < 0:  # beyond the ladder
                _host_rows(out, measures, a, b, sel, cfg, metrics)
                continue
            pending.append(_device_dispatch(measures, a, b, la, lb, sel, width, cfg, device,
                                            metrics))
        for item in pending:
            _device_collect(out, measures, item, cfg, metrics)
        with maybe_span(metrics, "strsim.release"):
            # the encoded columns' pages go back to the system here, inside the
            # call's span, and not as its frame is torn down
            del a, b
    return {m: (out[m], validity) for m in measures}


def classify(a: EncodedColumn, b: EncodedColumn, cfg: StrsimConfig):
    """Rows decided on the host: (validity, la, lb, trivial, one_empty,
    idx). la, lb: int32 lengths, 0 at null rows; trivial: both empty or
    byte-equal (score 1.0); one_empty: one side empty (0.0); idx: the rows
    that need kernel math."""
    validity = a.validity & b.validity
    la = np.where(validity, a.lengths, 0).astype(np.int32)
    lb = np.where(validity, b.lengths, 0).astype(np.int32)
    trivial = validity & (la == 0) & (lb == 0)
    if cfg.equal_fast_path and a.n:
        trivial = trivial | (validity & enc.equal_rows(a, b))
    work = validity & ~trivial
    one_empty = work & ((la == 0) | (lb == 0))
    return validity, la, lb, trivial, one_empty, np.nonzero(work & ~one_empty)[0]


@functools.lru_cache(maxsize=16)
def bucket_ranks(buckets: Tuple[int, ...], overflow_policy: str,
                 max_extend_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """(widths, rank_of) of a config's ladder: widths, int64, -1 (the rows
    beyond the ladder) and then every width `StrsimConfig.bucket_for` can
    give, ascending; rank_of, int32, for each max length 0..the widest, the
    index in widths of its bucket (0 beyond the ladder). bucket_for(m) ==
    widths[rank_of[m]], and -1 for every m past the widest. Read-only,
    cached per ladder."""
    extended = []
    if overflow_policy == "extend":  # bucket_for's 2L + 1 edges up to max_extend_len
        edge = buckets[-1]
        while edge * 2 + 1 <= max_extend_len:
            edge = edge * 2 + 1
            extended.append(edge)
    top = max([*buckets, *extended])
    bucket_of = np.full(top + 1, -1, dtype=np.int64)
    for edge in reversed(buckets):  # the first edge in the ladder's order that fits
        bucket_of[: edge + 1] = edge
    if extended:
        past = np.arange(max(buckets) + 1, top + 1)
        bucket_of[past] = np.array(extended)[np.searchsorted(extended, past)]
    widths = np.unique(np.concatenate([[-1], bucket_of]))
    rank_of = np.searchsorted(widths, bucket_of).astype(np.int32)
    widths.flags.writeable = rank_of.flags.writeable = False
    return widths, rank_of


def _ladder(cfg: StrsimConfig) -> Tuple[np.ndarray, np.ndarray]:
    return bucket_ranks(tuple(cfg.buckets), cfg.overflow_policy, cfg.max_extend_len)


def bucket_rows(idx, la, lb, cfg: StrsimConfig) -> Dict[int, np.ndarray]:
    """{bucket width: rows of idx in it}, by max(la, lb) on the ladder, -1
    first (the rows beyond the ladder, scored on the host, in row order),
    then the widths ascending, each bucket's rows ordered by la + lb, ties
    in row order: one stable counting pass of the native library
    (`binding.order_rows`). Each value is a slice of that pass's output.
    idx: int64 rows in row order; la, lb: int32 lengths."""
    if not idx.size:
        return {}
    widths, rank_of = _ladder(cfg)
    order, ends = nb.order_rows(idx, la, lb, rank_of, widths.size)
    starts = np.concatenate([[0], ends[:-1]])
    return {int(w): order[lo:hi] for w, lo, hi in zip(widths, starts, ends) if hi > lo}


def _narrow_bucket(cfg: StrsimConfig, a, b, sel, width: int):
    """Per-bucket tile (dtype, max_char): int8 when the bucket is pure ASCII,
    else int32. max_char is None when no scan happened (narrowing off, an
    empty bucket, or columns already encoded int8)."""
    if not (cfg.narrow_tiles and sel.size):
        return np.int32, None
    if a.codes.dtype == np.int8 and b.codes.dtype == np.int8:
        return np.int8, None
    mx = max(
        int(a.codes[sel, :width].max(initial=0)),
        int(b.codes[sel, :width].max(initial=0)),
    )
    return (np.int8 if mx < 128 else np.int32), mx


def _pad_codes(codes: np.ndarray, pad: int, width: int) -> np.ndarray:
    n, w = codes.shape
    if w == width:
        return codes
    padded = np.full((n, width), pad, dtype=codes.dtype)
    padded[:, : min(w, width)] = codes[:, :width]
    return padded


def stage_bucket(measures, a, b, la, lb, sel, width: int, cfg: StrsimConfig,
                 device: torch.device, metrics=None) -> dict:
    """Pack one bucket's rows `sel` with their lengths into a staging buffer
    (pinned for a CUDA device) padded to whole blocks. `sel` arrives ordered
    by la + lb from `bucket_rows` (length-ordered rows keep a warp's per-row
    trip counts close together) and is staged in that order. Returns the
    staged bucket: "sel", "block", "n_pad", "dtype" and "host", the staging
    tensors ([n_pad, 2 * width] codes, a | b per row, and [2, n_pad] int32
    lengths); `upload_bucket` sends them to `device`."""
    dtype, _ = _narrow_bucket(cfg, a, b, sel, width)
    block = min(_block_rows(width, cfg, measures, dtype), _round_batch(sel.size, cfg))
    n_pad = -(-sel.size // block) * block
    with maybe_span(metrics, "strsim.stage.alloc"):
        host_codes, packed = staging_empty((n_pad, 2 * width), dtype, device)
        host_lens, lens = staging_empty((2, n_pad), np.int32, device)
    if metrics is not None:
        metrics.count("stage.bytes", packed.nbytes + lens.nbytes)
    with maybe_span(metrics, "strsim.stage.pack"):
        if a.codes.dtype == dtype and b.codes.dtype == dtype:
            nb.pack_bucket(np.ascontiguousarray(a.codes), np.ascontiguousarray(b.codes), la, lb,
                           sel, width, enc.PAD_A, enc.PAD_B, packed, lens)
        else:  # int32 columns into an int8 (ASCII) bucket: narrow while packing
            for half, side, pad in ((slice(0, width), a, enc.PAD_A),
                                    (slice(width, 2 * width), b, enc.PAD_B)):
                codes = (side.codes[sel, :width] if side.width >= width
                         else _pad_codes(side.codes[sel], pad, width))
                packed[: sel.size, half] = codes
                packed[sel.size :, half] = pad
            lens[:, sel.size :] = 0
            lens[0, : sel.size] = la[sel]
            lens[1, : sel.size] = lb[sel]
    return {"sel": sel, "block": block, "n_pad": n_pad, "dtype": np.dtype(dtype).name,
            "host": (host_codes, host_lens)}


def upload_bucket(staged: dict, device: torch.device) -> dict:
    """Start the staged bucket's upload to `device` without blocking: adds
    "codes" and "lens", the device tensors. The staging tensors ("host")
    must stay alive until the upload has completed (the collect's download
    waits for it). Returns `staged`."""
    host_codes, host_lens = staged["host"]
    staged["codes"] = host_codes.to(device, non_blocking=True)
    staged["lens"] = host_lens.to(device, non_blocking=True)
    return staged


def bucket_blocks(staged: dict, width: int):
    """The uploaded bucket's blocks as the stat calls take them: (a, b,
    len_a, len_b), column slices of the packed tile (row stride 2 * width,
    no copy)."""
    codes, lens, block = staged["codes"], staged["lens"], staged["block"]
    for start in range(0, staged["n_pad"], block):
        rows = slice(start, start + block)
        yield codes[rows, :width], codes[rows, width:], lens[0, rows], lens[1, rows]


def _device_dispatch(measures, a, b, la, lb, sel, width, cfg, device, metrics=None):
    """Stage one bucket, upload it and launch the stat kernels block by
    block. Returns a pending record for _device_collect."""
    with maybe_span(metrics, "strsim.stage", width=width):
        staged = stage_bucket(measures, a, b, la, lb, sel, width, cfg, device, metrics)
        fields = _stat_fields(measures)
        impls = cfg.impls()
        outs = []
        with maybe_span(metrics, "strsim.enqueue"):
            upload_bucket(staged, device)
            for block in bucket_blocks(staged, width):
                stats = compute_stats(*block, measures, impls)
                outs.append(torch.stack([stats[f] for f in fields]))
        sel = staged["sel"]
        return {**staged, "width": width, "lens_a": la[sel], "lens_b": lb[sel], "outs": outs}


def _device_collect(out, measures, item, cfg, metrics=None):
    width, sel = item["width"], item["sel"]
    with maybe_span(metrics, "strsim.collect", width=width):
        with maybe_span(metrics, "strsim.collect.download", width=width):
            # waits for the uploads and kernels; [fields, n_pad] int32, C order,
            # so each field's row is a contiguous vector
            host = torch.cat(item["outs"], dim=1).cpu().numpy()
            stats = {f: host[i, : sel.size] for i, f in enumerate(_stat_fields(measures))}
        lens_a, lens_b = item["lens_a"], item["lens_b"]
        with maybe_span(metrics, "strsim.finalize"):
            stats64 = None
            for m in measures:
                if cfg.native_finalize and m in nb.FINALIZE_FIELDS:
                    nb.finalize_scatter(m, stats, lens_a, lens_b, out[m], sel)
                    continue
                if stats64 is None:
                    stats64 = {f: v.astype(np.int64) for f, v in stats.items()}
                out[m][sel] = MEASURES[m].finalizer(stats64, lens_a.astype(np.int64),
                                                    lens_b.astype(np.int64))
        if metrics is not None:
            bm = metrics.bucket(width)
            bm.dtype = item["dtype"]
            bm.rows += int(sel.size)
            bm.padded_rows += int(item["n_pad"] - sel.size)
            bm.char_lanes += int(sel.size) * width
            bm.useful_char_lanes += int(np.maximum(lens_a, lens_b).sum())
            bm.device_calls += len(item["outs"])


def _host_rows(out, measures, a, b, sel, cfg, metrics=None):
    """Score rows on the host (small inputs, rows beyond the ladder): the
    native scalar kernels on every core, or the oracle (fallback="oracle").
    Counted as `oracle_rows`, the JAX engine's name for host-scored rows."""
    with maybe_span(metrics, "strsim.host_rows"):
        if cfg.fallback == "native":
            for m in measures:
                out[m][sel] = nb.native_compute(m, a.codes[sel], a.lengths[sel], b.codes[sel],
                                                b.lengths[sel])
        else:
            for i in sel:
                sa = enc.decode_row(a.codes[i], int(a.lengths[i]))
                sb = enc.decode_row(b.codes[i], int(b.lengths[i]))
                for m in measures:
                    out[m][i] = MEASURES[m].oracle(sa, sb)
        if metrics is not None:
            metrics.oracle_rows += int(len(sel))
            metrics.device_rows -= int(len(sel))
