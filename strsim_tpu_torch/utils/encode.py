"""Host-side string ingestion: columns of strings -> codepoint tiles.

Three routes, chosen by what the input is and what the native library
offers, as `strsim_tpu/utils/encode.py` chooses them:

  native_objects  a list or object array of str|None: the native library
                  reads each str's codepoints in place (CPython's compact
                  representation) and writes them straight into the padded
                  tile, in threads; int8 tiles when every row is ASCII.
                  Needs a library compiled with Python.h.
  native_utf8     the same columns through one UTF-8 join and the native
                  decoder, where the library has no object routes; int32.
  numpy           numpy's fixed-width unicode dtype ('<U{L}', UCS4) for an
                  empty column, and as the reference route that the native
                  ones are held to (`encode_pair_numpy`).

`encode_pair` encodes both columns of a pair into one shared width, and
`encode_pair_with_route` also says which route did it. Lengths are the
Python strings' own (len(s)), so embedded and trailing NUL characters count
as the reference counts them.

Padding sentinels: PAD_A = -1 and PAD_B = -2. Real codepoints are >= 0, so an
a-pad never equals a b-pad and neither equals a real character: kernels need
no validity masks on character equality.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import sys
from typing import Optional, Tuple

import numpy as np

from strsim_tpu_torch.native import binding as nb
from strsim_tpu_torch.native.build import has_object_routes
from strsim_tpu_torch.utils.alloc import fast_empty

PAD_A = -1
PAD_B = -2


@dataclasses.dataclass
class EncodedColumn:
    """A decoded string column.

    codes:    [N, L] codepoints (int32, or int8 for columns the native
              encode found pure ASCII), PAD-filled past each row's length.
    lengths:  [N] int32 codepoint counts (0 for null rows).
    validity: [N] bool, False where the input was null (None).
    """

    codes: np.ndarray
    lengths: np.ndarray
    validity: np.ndarray

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def width(self) -> int:
        return self.codes.shape[1]


def _to_object_array(col) -> np.ndarray:
    """Normalize a column input to a 1-D object ndarray of str|None."""
    if hasattr(col, "to_list"):
        col = col.to_list()
    elif hasattr(col, "to_pylist"):
        col = col.to_pylist()
    if isinstance(col, np.ndarray) and col.dtype != object:
        col = col.tolist()
    arr = np.empty(len(col), dtype=object)
    arr[:] = list(col)
    return arr


def encode_column_numpy(col, pad: int = PAD_A, width: Optional[int] = None) -> EncodedColumn:
    """The numpy route: a column of str|None into an int32 EncodedColumn.

    `width`: tile width; defaults to the longest row (min 1, so an empty
    column still has a [0, 1] tile). Accepts lists, numpy arrays and anything
    exposing to_list/to_pylist.
    """
    arr = _to_object_array(col).copy()  # null replacement must not mutate caller data
    n = arr.shape[0]
    validity = np.ones(n, dtype=bool)
    for i, v in enumerate(arr):
        if v is None:
            validity[i] = False
            arr[i] = ""
        elif not isinstance(v, str):
            raise TypeError(f"expected str or None at row {i}, got {type(v).__name__}")

    if n == 0:
        return EncodedColumn(
            codes=np.full((0, width or 1), pad, dtype=np.int32),
            lengths=np.zeros(0, dtype=np.int32),
            validity=validity,
        )

    u = np.asarray(arr, dtype=str)  # one C pass: object strs -> UCS4 '<Umax'
    # lengths from the Python strings: np str_len drops a trailing U+0000
    lengths = np.fromiter(map(len, arr.tolist()), dtype=np.int32, count=n)
    max_len = int(lengths.max())
    w = width if width is not None else max(max_len, 1)
    if max_len > w:
        raise ValueError(f"width {w} smaller than longest row ({max_len})")
    if u.dtype.itemsize != 4 * w:
        u = u.astype(f"<U{w}")
    codes = u.view(np.uint32).reshape(n, w).astype(np.int32)
    mask = np.arange(w, dtype=np.int32)[None, :] < lengths[:, None]
    codes = np.where(mask, codes, np.int32(pad))
    return EncodedColumn(codes=codes, lengths=lengths, validity=validity)


def encode_pair_numpy(col_a, col_b, width: Optional[int] = None
                      ) -> Tuple[EncodedColumn, EncodedColumn]:
    """Both columns through the numpy route, at one shared width (int32)."""
    a = encode_column_numpy(col_a, pad=PAD_A)
    b = encode_column_numpy(col_b, pad=PAD_B)
    w = width if width is not None else max(a.width, b.width)
    return _repad(a, PAD_A, w), _repad(b, PAD_B, w)


@functools.lru_cache(maxsize=None)
def _list_items_offset() -> Optional[int]:
    """Offset of a CPython list's item array pointer (ob_item) in the list
    object, or None where it is not the 64-bit CPython layout. Checked once
    on a probe list whose item addresses must read back as their id()s."""
    if sys.implementation.name != "cpython" or sys.maxsize <= 2 ** 32 \
            or sys.getsizeof([]) != 56:  # PyObject 16 + size 8 + ob_item 8 + allocated 8 + GC 16
        return None
    probe = [None, "probe", 3.5]
    addr = ctypes.c_void_p.from_address(id(probe) + 24).value
    items = (ctypes.c_void_p * 3).from_address(addr) if addr else None
    ok = items is not None and all((items[i] or 0) == id(probe[i]) for i in range(3))
    return 24 if ok else None


def _column_objects(col):
    """(address of n contiguous PyObject*, n, the object that holds row i at
    [i] and keeps the rows alive) for the native routes, or None for an
    empty column. A list is read in place through its item array, an object
    array through its data; anything else becomes an object array first."""
    if type(col) is list and col and _list_items_offset() is not None:
        return ctypes.c_void_p.from_address(id(col) + _list_items_offset()).value, len(col), col
    if isinstance(col, np.ndarray) and col.dtype == object and col.ndim == 1 \
            and col.flags.c_contiguous and col.shape[0]:
        return col.ctypes.data, col.shape[0], col
    arr = _to_object_array(col)
    return (arr.ctypes.data, arr.shape[0], arr) if arr.shape[0] else None


def _scan(objs) -> Tuple[int, bool, np.ndarray, np.ndarray]:
    """The native scan of one column: (max length, all ASCII, lengths,
    validity); raises TypeError at the first row that is neither str nor
    None."""
    addr, n, rows = objs
    max_len, all_ascii, lengths, validity = nb.scan_object_ptr(addr, n)
    if max_len < 0:
        row = -max_len - 1
        raise TypeError(f"expected str or None at row {row}, got {type(rows[row]).__name__}")
    return max_len, all_ascii, lengths, validity.view(bool)


def _encode_objects(objs, scan, pad: int, width: int, dtype) -> EncodedColumn:
    """The native_objects route's second pass: codes straight into a
    [n, width] tile of `dtype`."""
    addr, n, _ = objs
    _, _, lengths, validity = scan
    codes = fast_empty((n, width), dtype, populate=False)  # the threaded pass first-touches it
    rc = nb.encode_object_ptr(addr, n, width, pad, codes)
    if rc != 0:
        raise ValueError(f"row {rc - 1} longer than tile width {width}")
    return EncodedColumn(codes=codes, lengths=lengths, validity=validity)


def _width(max_len: int, width: Optional[int]) -> int:
    w = width if width is not None else max(max_len, 1)
    if max_len > w:
        raise ValueError(f"width {w} smaller than longest row ({max_len})")
    return w


def _encode_utf8(objs, pad: int, width: Optional[int]) -> EncodedColumn:
    """The native_utf8 route: one ''.join and .encode() of the column, then
    the native decoder (ASCII rows are a widening copy); int32 tiles."""
    _, n, rows = objs
    arr = rows if isinstance(rows, np.ndarray) else _to_object_array(rows)
    validity = np.array([v is not None for v in arr], dtype=bool)
    parts = []
    for i, v in enumerate(arr.tolist()):
        if v is not None and not isinstance(v, str):
            raise TypeError(f"expected str or None at row {i}, got {type(v).__name__}")
        parts.append(v or "")
    joined = "".join(parts)
    data = joined.encode("utf-8")
    char_lens = np.fromiter(map(len, parts), dtype=np.int64, count=n)
    byte_lens = char_lens if len(data) == len(joined) else np.fromiter(
        (len(s.encode("utf-8")) for s in parts), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(byte_lens, out=offsets[1:])
    w = _width(int(char_lens.max()), width)
    codes, lengths = nb.decode_utf8_column(np.frombuffer(data, dtype=np.uint8), offsets, None,
                                           w, pad)
    return EncodedColumn(codes=codes, lengths=lengths, validity=validity)


def _encode_column(col, pad: int, width: Optional[int]) -> Tuple[EncodedColumn, str]:
    objs = _column_objects(col)
    if objs is None:
        return encode_column_numpy(col, pad=pad, width=width), "numpy"
    if not has_object_routes():
        return _encode_utf8(objs, pad, width), "native_utf8"
    scan = _scan(objs)
    dtype = np.int8 if scan[1] else np.int32
    return _encode_objects(objs, scan, pad, _width(scan[0], width), dtype), "native_objects"


def encode_column(col, pad: int = PAD_A, width: Optional[int] = None) -> EncodedColumn:
    """Decode a column of str|None into an EncodedColumn by the native
    routes (int8 tiles for an all-ASCII column when the library reads str
    objects in place). `width`: tile width; defaults to the longest row (min
    1). Accepts lists, tuples, numpy arrays and anything exposing
    to_list/to_pylist."""
    return _encode_column(col, pad, width)[0]


def encode_pair_with_route(col_a, col_b, width: Optional[int] = None
                           ) -> Tuple[EncodedColumn, EncodedColumn, str]:
    """Encode two columns at one shared tile width; also the route that did
    it ("native_objects", "native_utf8" or "numpy"; "a+b" when the columns
    took different ones). The native_objects route scans both columns first,
    then writes each straight into the shared width, int8 when both are
    ASCII."""
    objs = (_column_objects(col_a), _column_objects(col_b))
    if None not in objs and has_object_routes():
        scans = [_scan(o) for o in objs]
        w = _width(max(scans[0][0], scans[1][0]), width)
        dtype = np.int8 if scans[0][1] and scans[1][1] else np.int32
        a, b = (_encode_objects(o, s, pad, w, dtype)
                for o, s, pad in zip(objs, scans, (PAD_A, PAD_B)))
        return a, b, "native_objects"
    a, route_a = _encode_column(col_a, PAD_A, None)
    b, route_b = _encode_column(col_b, PAD_B, None)
    w = width if width is not None else max(a.width, b.width)
    route = route_a if route_a == route_b else f"{route_a}+{route_b}"
    return _repad(a, PAD_A, w), _repad(b, PAD_B, w), route


def encode_pair(col_a, col_b, width: Optional[int] = None
                ) -> Tuple[EncodedColumn, EncodedColumn]:
    """Encode two columns with a shared tile width (paired kernels need it)."""
    a, b, _ = encode_pair_with_route(col_a, col_b, width)
    return a, b


def _repad(c: EncodedColumn, pad: int, width: int) -> EncodedColumn:
    if c.width == width:
        return c
    if c.width > width:
        raise ValueError("cannot shrink below content width")
    wide = fast_empty((c.n, width), c.codes.dtype)
    wide[:, : c.width] = c.codes
    wide[:, c.width :] = pad
    return EncodedColumn(codes=wide, lengths=c.lengths, validity=c.validity)


def decode_row(codes: np.ndarray, length: int) -> str:
    """Inverse of encode: codepoints -> str."""
    return "".join(chr(int(c)) for c in codes[:length])


def equal_rows(a: EncodedColumn, b: EncodedColumn) -> np.ndarray:
    """Per-row string equality (the reference's a == b fast path,
    strsim.rs:128), threaded in the native library: lengths equal and the
    first len chars equal. Pads differ between sides, so no pad can match.
    Tiles of two dtypes (caller-encoded columns) compare as int32."""
    if a.width != b.width:
        w = max(a.width, b.width)
        a = _repad(a, PAD_A, w)
        b = _repad(b, PAD_B, w)
    ca, cb = np.ascontiguousarray(a.codes), np.ascontiguousarray(b.codes)
    if ca.dtype != cb.dtype:
        ca, cb = ca.astype(np.int32), cb.astype(np.int32)
    return nb.equal_rows_native(ca, cb, a.lengths, b.lengths)


def equal_rows_numpy(a: EncodedColumn, b: EncodedColumn) -> np.ndarray:
    """The numpy form of `equal_rows`: a row is equal iff the lengths match
    and the count of equal positions equals that length."""
    if a.width != b.width:
        w = max(a.width, b.width)
        a = _repad(a, PAD_A, w)
        b = _repad(b, PAD_B, w)
    same_len = a.lengths == b.lengths
    eq_count = np.count_nonzero(a.codes == b.codes, axis=1)
    return same_len & (eq_count == a.lengths)
