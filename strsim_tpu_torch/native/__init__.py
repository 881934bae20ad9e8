"""The native host layer: a C++ library (strsim_host.cpp) built with g++ at
first use (build.py) and called through ctypes (binding.py).

It encodes string columns into tiles, orders the device rows by bucket,
packs buckets, finalizes and scatters scores, and scores host rows on every
core. Nothing builds at import.
"""
from strsim_tpu_torch.native.binding import (
    FINALIZE_FIELDS,
    MEASURE_IDS,
    decode_utf8_column,
    equal_rows_native,
    finalize_scatter,
    native_compute,
    native_phonetic_codes,
    order_rows,
    pack_bucket,
)
from strsim_tpu_torch.native.build import build_library, get_lib, has_object_routes

__all__ = [
    "FINALIZE_FIELDS",
    "MEASURE_IDS",
    "build_library",
    "decode_utf8_column",
    "equal_rows_native",
    "finalize_scatter",
    "get_lib",
    "has_object_routes",
    "native_compute",
    "native_phonetic_codes",
    "order_rows",
    "pack_bucket",
]
