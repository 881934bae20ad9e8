"""Engine configuration for the PyTorch/CUDA engine.

Same knobs as `strsim_tpu.config.StrsimConfig` for everything the main path
reads: the bucket ladder, the overflow/extend policy, batch rounding, tile
narrowing, the equal fast path, the small-input host short-circuit and the
six per-family kernel overrides (`levenshtein_impl` ... `lcs_impl`, with the
JAX engine's values). The TPU-only fields (mesh, compile and execute
deadlines, host fallbacks, Pallas block rows) have no counterpart. "auto"
picks a kernel by bucket width and tile dtype, as the JAX engine does on a
TPU; a forced value picks the counterpart of the JAX function it selects
(`ops/stats.py`). A kernel that fails to build or launch raises instead of
falling back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# Values of each per-family override, as strsim_tpu/config.py:38-93 documents
# them ("xla" aliases "myers" for levenshtein and "bitmask" for jaro). The
# kernel each forced value reaches is in ops/stats.py.
IMPL_VALUES: Dict[str, Tuple[str, ...]] = {
    "levenshtein": ("auto", "myers", "xla", "pallas_scan", "wavefront", "pallas"),
    "jaro": ("auto", "bitmask", "xla", "scan", "pallas", "pallas_scan", "pallas_scan_h",
             "pallas_scan_f"),
    "multiset": ("auto", "pallas_scan", "pallas_hist", "chunked", "xla", "table"),
    "osa": ("auto", "myers", "pallas_scan"),
    "bigram": ("auto", "xla", "pallas_scan"),
    "lcs": ("auto", "xla", "pallas_scan"),
}


@dataclasses.dataclass(frozen=True)
class StrsimConfig:
    # Length buckets (chars): a row pair lands in the smallest edge that fits
    # max(len_a, len_b). ~1.5x ladder caps padded-length waste on the O(L^2)
    # stats; the same edges as the JAX engine so both bucket identically.
    buckets: Tuple[int, ...] = (7, 15, 23, 31, 47, 63, 95, 127, 191, 255, 383, 511)

    # Rows longer than the largest bucket: "oracle" scores them on the host
    # (by the `fallback` scorer); "extend" grows ad-hoc 2L+1 buckets up to
    # max_extend_len, computed on the device by the plain torch stats.
    overflow_policy: str = "extend"
    max_extend_len: int = 16384

    # Bucket batches are padded up to a size from a small menu
    # (models/pipeline.py:_BATCH_MENU); padded rows are zero-length.
    min_batch: int = 8
    max_batch_block: int = 262144

    # Buckets whose codepoints are all ASCII ship as int8 tiles (4x less
    # host->device traffic) and take the histogram multiset kernel when wide.
    narrow_tiles: bool = True

    # Byte-equal pairs score 1.0 on the host without touching the device
    # (the reference's a == b fast path, strsim.rs:128).
    equal_fast_path: bool = True

    # When at most this many rows need kernel math, score them on the host
    # (the `fallback` scorer) instead: a size policy for tiny inputs, where
    # the host is faster than a device round trip; not a fallback. Set from
    # the crossover that the port's first benchmark harness (since removed)
    # measured; PERF.md's Findings name that run, and no tool in the repo
    # measures it now. On an H100 80GB HBM3 (700 W) and
    # its host, the native library on every core beat the device up to 922
    # rows of short names (make_pairs) but only up to 8 rows of 48..511
    # chars (make_wide_pairs), whose scalar DP costs grow as la * lb; the
    # smaller holds for both. The JAX engine's 8192 pays for a TPU compile.
    host_short_circuit_rows: int = 8

    # Scorer of the host rows (the short circuit above, and rows beyond the
    # ladder): "native" the native library's scalar kernels on every core,
    # "oracle" the pure-Python oracle. Both are exact; the name is the JAX
    # engine's, whose host path also served as its fallback.
    fallback: str = "native"

    # Finalize and scatter each bucket's integer stats in the native library
    # (threaded, the reference's evaluation order, byte-identical to
    # ops/finalize.py); False takes the numpy finalizers.
    native_finalize: bool = True

    # Kernel per measure family (IMPL_VALUES). "auto" takes what the JAX
    # engine takes on a TPU: its Pallas kernels' counterparts up to width 512
    # (K5 for lev + jaro at widths <= 64), plain torch past them. A forced
    # value takes the counterpart of the JAX function it forces: a Pallas
    # kernel's CUDA kernel (levenshtein "pallas" -> K10 levenshtein_wavefront,
    # jaro "pallas" -> K9 jaro_flags), an XLA form's plain torch version.
    levenshtein_impl: str = "auto"
    jaro_impl: str = "auto"
    multiset_impl: str = "auto"
    osa_impl: str = "auto"
    bigram_impl: str = "auto"
    lcs_impl: str = "auto"

    # torch device for the stat kernels. "cuda" raises when no GPU is
    # present; "cpu" runs the plain torch versions of every kernel.
    device: str = "cuda"

    def __post_init__(self):
        if self.fallback not in ("native", "oracle"):
            raise ValueError(f"fallback={self.fallback!r}: expected 'native' or 'oracle'")
        for family, values in IMPL_VALUES.items():
            value = getattr(self, f"{family}_impl")
            if value not in values:
                raise ValueError(f"{family}_impl={value!r}: expected one of {values}")

    def impls(self) -> Dict[str, str]:
        """{family: override} for the router (ops/stats.py:resolve_impls)."""
        return {family: getattr(self, f"{family}_impl") for family in IMPL_VALUES}

    def bucket_for(self, max_len: int) -> int:
        for edge in self.buckets:
            if max_len <= edge:
                return edge
        if self.overflow_policy == "extend":
            edge = self.buckets[-1]
            while edge < max_len and edge <= self.max_extend_len:
                edge = edge * 2 + 1
            if max_len <= edge and edge <= self.max_extend_len:
                return edge
        return -1  # caller scores the row on the host

    def replace(self, **kw) -> "StrsimConfig":
        return dataclasses.replace(self, **kw)


_CONFIG = StrsimConfig()


def get_config() -> StrsimConfig:
    return _CONFIG


def set_config(config: StrsimConfig) -> None:
    global _CONFIG
    _CONFIG = config
