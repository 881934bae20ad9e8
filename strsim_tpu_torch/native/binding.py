"""numpy/ctypes bindings over the native host library (`strsim_host.cpp`).

The counterpart of `strsim_tpu/native/binding.py`, with the same measure
ids and finalize fields. Every entry point validates dtypes, shapes and
contiguity before it passes a pointer, and raises on what the library does
not take; none returns a "not available" answer for a caller to fall back
on (a library that fails to build raises in `build.get_lib`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from strsim_tpu_torch.native.build import get_lib, get_pylib
from strsim_tpu_torch.utils.alloc import fast_empty

MEASURE_IDS = {
    "levenshtein": 0,
    "jaro": 1,
    "jaro_winkler": 2,
    "jaccard": 3,
    "sorensen_dice": 4,
    # extension measures (ids must match strsim_host.cpp compute_range)
    "jaccard_bigram": 5,
    "sorensen_dice_bigram": 6,
    "cosine": 7,
    "overlap": 8,
    "hamming": 9,
    "lcs_seq": 10,
    "indel": 11,
    "osa": 12,
    "soundex": 13,
}

# Stat fields per measure, in the (s0, s1, s2) order strsim_host.cpp's
# finalize_range reads them.
FINALIZE_FIELDS = {
    "levenshtein": ("lev_d",),
    "jaro": ("jaro_m", "jaro_t"),
    "jaro_winkler": ("jaro_m", "jaro_t", "prefix"),
    "jaccard": ("inter",),
    "sorensen_dice": ("inter",),
    "jaccard_bigram": ("inter2", "eq"),
    "sorensen_dice_bigram": ("inter2", "eq"),
    "cosine": ("inter",),
    "overlap": ("inter",),
    "hamming": ("ham_m",),
    "lcs_seq": ("lcs_len",),
    "indel": ("lcs_len",),
    "osa": ("osa_d",),
    "soundex": ("sdx_eq",),
}

PHONETIC_METHODS = {"soundex": 0, "nysiis": 1}


def _addr(arr: Optional[np.ndarray]) -> Optional[int]:
    return None if arr is None else arr.ctypes.data


def _int32(name: str, arr, n: int) -> np.ndarray:
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    if arr.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {arr.shape}")
    return arr


def _tiles(codes_a: np.ndarray, codes_b: np.ndarray) -> int:
    """Checks two [n, w] code tiles of one dtype (int8 or int32), C order;
    returns the element size."""
    for name, c in (("codes_a", codes_a), ("codes_b", codes_b)):
        if c.ndim != 2 or c.dtype not in (np.int8, np.int32) or not c.flags.c_contiguous:
            raise ValueError(f"{name} must be a C-contiguous 2-D int8 or int32 array, "
                             f"got {c.dtype} {c.shape}")
    if codes_a.dtype != codes_b.dtype or codes_a.shape != codes_b.shape:
        raise ValueError(f"tiles differ: {codes_a.dtype} {codes_a.shape} and "
                         f"{codes_b.dtype} {codes_b.shape}")
    return codes_a.dtype.itemsize


def finalize_scatter(measure: str, stats: Dict[str, np.ndarray], la, lb, out: np.ndarray,
                     sel: Optional[np.ndarray] = None) -> None:
    """Exact f64 finalize (the reference's evaluation order, strsim_host.cpp
    finalize_range), threaded, fused with the scatter out[sel[i]] = score(i)
    (out[i] when sel is None). Byte-identical to ops/finalize.py's numpy
    finalizers. stats: {field: int32 [n]} for FINALIZE_FIELDS[measure]; out:
    C-contiguous float64."""
    fields = FINALIZE_FIELDS[measure]
    n = len(la)
    svec = [_int32(f, stats[f], n) for f in fields]
    svec += [None] * (3 - len(svec))
    la32, lb32 = _int32("la", la, n), _int32("lb", lb, n)
    if sel is not None:
        sel = np.ascontiguousarray(sel, dtype=np.int64)
        if sel.shape != (n,):
            raise ValueError(f"sel must have shape ({n},), got {sel.shape}")
    if out.dtype != np.float64 or not out.flags.c_contiguous or out.ndim != 1:
        raise ValueError(f"out must be a C-contiguous float64 vector, got {out.dtype} {out.shape}")
    reach = int(sel.max()) + 1 if sel is not None and n else n
    if reach > out.shape[0] or (sel is not None and n and int(sel.min()) < 0):
        raise ValueError(f"scatter indices reach past out's {out.shape[0]} rows")
    get_lib().strsim_finalize_scatter(MEASURE_IDS[measure], *map(_addr, svec), _addr(la32),
                                      _addr(lb32), _addr(sel), n, _addr(out))


def scan_object_ptr(objs_addr: int, n: int) -> Tuple[int, bool, np.ndarray, np.ndarray]:
    """Pass 1 over n PyObject* at `objs_addr` (threaded, no reference
    counting): (max length, or -(row + 1) at the first row that is neither
    str nor None; all ASCII; lengths int32; validity uint8). Through the
    PyDLL handle: the GIL stays held while the library's threads read the
    objects (build.get_pylib)."""
    lengths = np.empty(n, dtype=np.int32)
    validity = np.empty(n, dtype=np.uint8)
    all_ascii = ctypes.c_int32(0)
    rc = get_pylib().strsim_scan_object_column(objs_addr, n, id(None), id(str), _addr(lengths),
                                               _addr(validity), ctypes.addressof(all_ascii))
    return int(rc), bool(all_ascii.value), lengths, validity


def encode_object_ptr(objs_addr: int, n: int, width: int, pad: int, codes: np.ndarray) -> int:
    """Pass 2: fill the caller's [n, width] tile (int8 for an all-ASCII
    column, else int32) from n PyObject* at `objs_addr`. Returns 0, or
    row + 1 of a row longer than `width`. GIL held, as scan_object_ptr."""
    if codes.shape != (n, width) or codes.dtype not in (np.int8, np.int32) \
            or not codes.flags.c_contiguous:
        raise ValueError(f"codes must be a C-contiguous [{n}, {width}] int8 or int32 array")
    return int(get_pylib().strsim_encode_object_column(objs_addr, n, id(None), width, pad,
                                                       codes.dtype.itemsize, _addr(codes)))


def decode_utf8_column(data: np.ndarray, offsets: np.ndarray, validity: Optional[np.ndarray],
                       width: int, pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """UTF-8 column buffers -> ([n, width] int32 codes, PAD past each row;
    [n] int32 lengths). data: uint8 bytes; offsets: int64 [n + 1]; validity:
    optional uint8 [n], 0 = null. Raises if a row exceeds `width` chars."""
    n = offsets.shape[0] - 1
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if n and (offsets[0] < 0 or offsets[-1] > data.size or np.any(np.diff(offsets) < 0)):
        raise ValueError("offsets must rise from 0 within the data")
    val = None if validity is None else _int8_vector("validity", validity, n)
    codes = fast_empty((n, width), np.int32, populate=False)  # the library pad-fills it
    lengths = np.empty(n, dtype=np.int32)
    rc = get_lib().strsim_decode_utf8_column(_addr(data), _addr(offsets), _addr(val), n, width,
                                             pad, _addr(codes), _addr(lengths))
    if rc != 0:
        raise ValueError(f"row {rc - 1} longer than tile width {width}")
    return codes, lengths


def _int8_vector(name: str, arr, n: int) -> np.ndarray:
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {arr.shape}")
    return arr


def equal_rows_native(codes_a: np.ndarray, codes_b: np.ndarray, len_a, len_b) -> np.ndarray:
    """Per-row equality of two padded tiles (lengths equal and the first
    len chars equal), threaded: bool [n]."""
    elem = _tiles(codes_a, codes_b)
    n, w = codes_a.shape
    la, lb = _int32("len_a", len_a, n), _int32("len_b", len_b, n)
    if n and max(int(la.max()), int(lb.max())) > w:
        raise ValueError(f"lengths exceed the tile width {w}")
    out = np.empty(n, dtype=np.uint8)
    get_lib().strsim_equal_rows(_addr(codes_a), _addr(codes_b), _addr(la), _addr(lb), n, w,
                                elem, _addr(out))
    return out.view(bool)


def pack_bucket(codes_a: np.ndarray, codes_b: np.ndarray, len_a, len_b, sel, width: int,
                pad_a: int, pad_b: int, packed: np.ndarray, lens: np.ndarray) -> None:
    """Gather rows `sel` of two [N, w] tiles into `packed` ([n_out, 2 *
    width], a-row | b-row, of the tiles' dtype; chars past `width` dropped,
    pads past w) and their lengths into `lens` ([2, n_out] int32: a's, then
    b's), one threaded pass. Rows past len(sel) up to n_out are pad rows of
    length 0. Both outputs are the caller's (the pipeline's pinned staging
    buffers)."""
    elem = _tiles(codes_a, codes_b)
    n_src, w_src = codes_a.shape
    sel = np.ascontiguousarray(sel, dtype=np.int64)
    la, lb = _int32("len_a", len_a, n_src), _int32("len_b", len_b, n_src)
    n_out = packed.shape[0]
    if packed.shape != (n_out, 2 * width) or packed.dtype != codes_a.dtype \
            or not packed.flags.c_contiguous:
        raise ValueError(f"packed must be a C-contiguous [n, {2 * width}] {codes_a.dtype} array, "
                         f"got {packed.dtype} {packed.shape}")
    if lens.shape != (2, n_out) or lens.dtype != np.int32 or not lens.flags.c_contiguous:
        raise ValueError(f"lens must be a C-contiguous [2, {n_out}] int32 array")
    if sel.ndim != 1 or sel.size > n_out or (sel.size and (sel.min() < 0 or sel.max() >= n_src)):
        raise ValueError(f"sel must hold at most {n_out} rows of 0..{n_src - 1}")
    if sel.size and max(int(la[sel].max()), int(lb[sel].max())) > width:
        raise ValueError(f"a selected row is longer than the bucket width {width}")
    get_lib().strsim_pack_bucket(_addr(codes_a), _addr(codes_b), w_src, _addr(la), _addr(lb),
                                 _addr(sel), sel.size, width, pad_a, pad_b, elem, _addr(packed),
                                 _addr(lens), n_out)


def ragged(codes: np.ndarray, lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A padded [n, w] tile -> (its rows' chars concatenated, int32; int64
    offsets [n + 1])."""
    lengths = np.asarray(lengths, dtype=np.int64)
    offsets = np.zeros(lengths.shape[0] + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    mask = np.arange(codes.shape[1])[None, :] < lengths[:, None]
    return np.ascontiguousarray(codes[mask], dtype=np.int32), offsets


def native_compute(measure: str, codes_a: np.ndarray, lengths_a, codes_b: np.ndarray, lengths_b,
                   validity: Optional[np.ndarray] = None, threads: int = 1) -> np.ndarray:
    """f64 scores of one measure by the scalar C++ kernels (the reference's
    algorithms and evaluation order): threads=1 is the single-core baseline,
    0 every core. NaN where `validity` is False."""
    n = len(lengths_a)
    if codes_a.shape[0] != n or codes_b.shape[0] != n or len(lengths_b) != n:
        raise ValueError("codes and lengths of both sides must have the same rows")
    fa, oa = ragged(codes_a, lengths_a)
    fb, ob = ragged(codes_b, lengths_b)
    val = None if validity is None else _int8_vector("validity", validity, n)
    out = np.empty(n, dtype=np.float64)
    args = (MEASURE_IDS[measure], _addr(fa), _addr(oa), _addr(fb), _addr(ob), _addr(val), n)
    if threads == 1:
        get_lib().strsim_compute(*args, _addr(out))
    else:
        get_lib().strsim_compute_mt(*args, threads, _addr(out))
    return out


def native_phonetic_codes(col, method: str = "soundex", key_width: int = 32,
                          threads: int = 0) -> np.ndarray:
    """Phonetic keys of a column (str|None values, or an EncodedColumn) by
    the threaded C++ encoder: an object array of str, None at null rows and
    "" for rows without letters. NYSIIS keys longer than key_width are cut
    to it."""
    from strsim_tpu_torch.utils import encode as enc

    if method not in PHONETIC_METHODS:
        raise KeyError(f"unknown phonetic method {method!r}; available: "
                       f"{', '.join(PHONETIC_METHODS)}")
    c = col if isinstance(col, enc.EncodedColumn) else enc.encode_column(col, pad=enc.PAD_A)
    n = c.n
    flat, off = ragged(c.codes, c.lengths)
    val = _int8_vector("validity", c.validity, n)
    out = np.zeros((n, key_width), dtype=np.uint8)
    out_lens = np.empty(n, dtype=np.int32)
    get_lib().strsim_phonetic_codes(PHONETIC_METHODS[method], _addr(flat), _addr(off), _addr(val),
                                    n, key_width, threads, _addr(out), _addr(out_lens))
    res = np.empty(n, dtype=object)
    for i in range(n):
        res[i] = None if out_lens[i] < 0 else out[i, :out_lens[i]].tobytes().decode("ascii")
    return res
