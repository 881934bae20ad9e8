"""The native host layer: a C++ library (strsim_host.cpp) built with g++ at
first use (build.py) and called through ctypes (binding.py).

It encodes string columns into tiles, packs buckets, finalizes and scatters
scores, scores host rows on every core, and gives the single-core baseline
that bench_torch.py compares the device with. Nothing builds at import.
"""
from strsim_tpu_torch.native.binding import (
    FINALIZE_FIELDS,
    MEASURE_IDS,
    decode_utf8_column,
    equal_rows_native,
    finalize_scatter,
    native_compute,
    native_phonetic_codes,
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
    "pack_bucket",
]
