"""Host-side string ingestion: columns of strings -> codepoint tiles.

numpy's fixed-width unicode dtype ('<U{L}') stores UCS4 codepoints, so
`np.asarray(list_of_str, dtype=str)` decodes a whole column in one C pass into
an [N, L] codepoint matrix. Lengths come from the Python strings (len(s)), so
embedded and trailing NUL characters count exactly as the reference counts
them.

Padding sentinels: PAD_A = -1 and PAD_B = -2. Real codepoints are >= 0, so an
a-pad never equals a b-pad and neither equals a real character: kernels need
no validity masks on character equality.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

PAD_A = -1
PAD_B = -2


@dataclasses.dataclass
class EncodedColumn:
    """A decoded string column.

    codes:    [N, L] codepoints (int32, or int8 for columns known to be pure
              ASCII), PAD-filled past each row's length.
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


def encode_column(col, pad: int = PAD_A, width: Optional[int] = None) -> EncodedColumn:
    """Decode a column of str|None into an int32 EncodedColumn.

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


def encode_pair(
    col_a, col_b, width: Optional[int] = None
) -> Tuple[EncodedColumn, EncodedColumn]:
    """Encode two columns with a shared tile width (paired kernels need it)."""
    a = encode_column(col_a, pad=PAD_A)
    b = encode_column(col_b, pad=PAD_B)
    w = width if width is not None else max(a.width, b.width)
    return _repad(a, PAD_A, w), _repad(b, PAD_B, w)


def _repad(c: EncodedColumn, pad: int, width: int) -> EncodedColumn:
    if c.width == width:
        return c
    if c.width > width:
        raise ValueError("cannot shrink below content width")
    wide = np.empty((c.n, width), dtype=c.codes.dtype)
    wide[:, : c.width] = c.codes
    wide[:, c.width :] = pad
    return EncodedColumn(codes=wide, lengths=c.lengths, validity=c.validity)


def decode_row(codes: np.ndarray, length: int) -> str:
    """Inverse of encode: codepoints -> str."""
    return "".join(chr(int(c)) for c in codes[:length])


def equal_rows(a: EncodedColumn, b: EncodedColumn) -> np.ndarray:
    """Per-row string equality (the reference's a == b fast path,
    strsim.rs:128). Pads differ between sides, so a row is equal iff the
    lengths match and the count of equal positions equals that length."""
    if a.width != b.width:
        w = max(a.width, b.width)
        a = _repad(a, PAD_A, w)
        b = _repad(b, PAD_B, w)
    same_len = a.lengths == b.lengths
    eq_count = np.count_nonzero(a.codes == b.codes, axis=1)
    return same_len & (eq_count == a.lengths)
