"""End-to-end scoring pipeline: string columns -> bucketed device batches ->
scores. The counterpart of `strsim_tpu/models/pipeline.py:compute_scores`:

  1. validate shapes and broadcast a length-1 side (strsim.rs:48-52, 61-66);
  2. resolve null, both-empty, byte-equal and one-empty rows on the host;
  3. bucket the remaining rows by max(len_a, len_b) onto the ladder, narrow
     pure-ASCII buckets to int8, sort each bucket by la + lb, pad it to a
     size from the batch menu, pack it (native library) into a pinned
     staging buffer, upload it once without blocking and run the stat
     kernels (ops/stats.py) block by block;
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
from strsim_tpu_torch.utils.metrics import timer

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
    collect occupancy, padding waste and phase timings.
    """
    cfg = config or get_config()
    device = _device(cfg)
    measures = resolve_measures(measures)
    tm = timer()
    t_total = timer()

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
        metrics.encode_wall_s += tm.lap()

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
        metrics.classify_wall_s += tm.lap()

    if idx.size and idx.size <= cfg.host_short_circuit_rows:
        # small input: the host scores it faster than a device round trip
        _host_rows(out, measures, a, b, idx, cfg, metrics)
        idx = idx[:0]

    # dispatch every bucket first (uploads and kernels queue on the stream),
    # then collect and finalize in order
    pending = []
    for width, sel in bucket_rows(idx, la, lb, cfg).items():
        if width < 0:  # beyond the ladder
            _host_rows(out, measures, a, b, sel, cfg, metrics)
            continue
        pending.append(_device_dispatch(measures, a, b, la, lb, sel, width, cfg, device))
    for item in pending:
        _device_collect(out, measures, item, cfg, metrics)

    if metrics is not None:
        metrics.total_wall_s += t_total.lap()
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


def bucket_rows(idx, la, lb, cfg: StrsimConfig) -> Dict[int, np.ndarray]:
    """{bucket width: rows of idx in it}, by max(la, lb) on the ladder; -1
    holds the rows beyond it (scored on the host)."""
    if not idx.size:
        return {}
    maxlen = np.maximum(la[idx], lb[idx])
    uniq = np.unique(maxlen)
    uniq_bucket = np.array([cfg.bucket_for(int(v)) for v in uniq], dtype=np.int64)
    bucket_of = uniq_bucket[np.searchsorted(uniq, maxlen)]
    return {int(w): idx[bucket_of == w] for w in np.unique(bucket_of)}


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
                 device: torch.device) -> dict:
    """Sort one bucket's rows `sel` by la + lb, pack them with their lengths
    into a staging buffer (pinned for a CUDA device) padded to whole blocks,
    and start the upload to `device` without blocking. Returns the staged
    bucket: "sel" (sorted), "block", "n_pad", "dtype", "codes" ([n_pad, 2 *
    width] on the device, a | b per row), "lens" ([2, n_pad] int32 on the
    device), and "host", the staging tensors, which must stay alive until
    the upload has completed (the collect's download waits for it)."""
    # length-sorted rows keep a warp's per-row trip counts close together
    sel = sel[np.argsort(la[sel].astype(np.int64) + lb[sel], kind="stable")]
    dtype, _ = _narrow_bucket(cfg, a, b, sel, width)
    block = min(_block_rows(width, cfg, measures, dtype), _round_batch(sel.size, cfg))
    n_pad = -(-sel.size // block) * block
    host_codes, packed = staging_empty((n_pad, 2 * width), dtype, device)
    host_lens, lens = staging_empty((2, n_pad), np.int32, device)
    if a.codes.dtype == dtype and b.codes.dtype == dtype:
        nb.pack_bucket(np.ascontiguousarray(a.codes), np.ascontiguousarray(b.codes), la, lb, sel,
                       width, enc.PAD_A, enc.PAD_B, packed, lens)
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
    return {
        "sel": sel, "block": block, "n_pad": n_pad, "dtype": np.dtype(dtype).name,
        "codes": host_codes.to(device, non_blocking=True),
        "lens": host_lens.to(device, non_blocking=True),
        "host": (host_codes, host_lens),
    }


def bucket_blocks(staged: dict, width: int):
    """The staged bucket's blocks as the stat calls take them: (a, b, len_a,
    len_b), column slices of the packed tile (row stride 2 * width, no
    copy)."""
    codes, lens, block = staged["codes"], staged["lens"], staged["block"]
    for start in range(0, staged["n_pad"], block):
        rows = slice(start, start + block)
        yield codes[rows, :width], codes[rows, width:], lens[0, rows], lens[1, rows]


def _device_dispatch(measures, a, b, la, lb, sel, width, cfg, device):
    """Stage one bucket and launch the stat kernels block by block. Returns
    a pending record for _device_collect."""
    tm = timer()
    staged = stage_bucket(measures, a, b, la, lb, sel, width, cfg, device)
    fields = _stat_fields(measures)
    impls = cfg.impls()
    outs = []
    for block in bucket_blocks(staged, width):
        stats = compute_stats(*block, measures, impls)
        outs.append(torch.stack([stats[f] for f in fields]))
    sel = staged["sel"]
    return {**staged, "width": width, "lens_a": la[sel], "lens_b": lb[sel], "outs": outs,
            "dispatch_dt": tm.lap()}


def _device_collect(out, measures, item, cfg, metrics=None):
    tm = timer()
    sel = item["sel"]
    # waits for the uploads and kernels; [fields, n_pad] int32, C order, so
    # each field's row is a contiguous vector
    host = torch.cat(item["outs"], dim=1).cpu().numpy()
    stats = {f: host[i, : sel.size] for i, f in enumerate(_stat_fields(measures))}
    device_dt = item["dispatch_dt"] + tm.lap()
    lens_a, lens_b = item["lens_a"], item["lens_b"]
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
        width = item["width"]
        bm = metrics.bucket(width)
        bm.dtype = item["dtype"]
        bm.rows += int(sel.size)
        bm.padded_rows += int(item["n_pad"] - sel.size)
        bm.char_lanes += int(sel.size) * width
        bm.useful_char_lanes += int(np.maximum(lens_a, lens_b).sum())
        bm.device_calls += len(item["outs"])
        bm.device_wall_s += device_dt
        metrics.device_wall_s += device_dt
        metrics.finalize_wall_s += tm.lap()


def _host_rows(out, measures, a, b, sel, cfg, metrics=None):
    """Score rows on the host (small inputs, rows beyond the ladder): the
    native scalar kernels on every core, or the oracle (fallback="oracle").
    Counted as `oracle_rows`, the JAX engine's name for host-scored rows."""
    if cfg.fallback == "native":
        for m in measures:
            out[m][sel] = nb.native_compute(m, a.codes[sel], a.lengths[sel], b.codes[sel],
                                            b.lengths[sel], threads=0)
    else:
        for i in sel:
            sa = enc.decode_row(a.codes[i], int(a.lengths[i]))
            sb = enc.decode_row(b.codes[i], int(b.lengths[i]))
            for m in measures:
                out[m][i] = MEASURES[m].oracle(sa, sb)
    if metrics is not None:
        metrics.oracle_rows += int(len(sel))
        metrics.device_rows -= int(len(sel))
