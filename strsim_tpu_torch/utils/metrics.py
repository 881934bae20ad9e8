"""Run metrics: rows by disposition (null / fast path / device / host),
per-bucket occupancy and padding waste, and wall time per phase. The pipeline
fills a RunMetrics when given one; collection costs nothing when off."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict


@dataclasses.dataclass
class BucketMetrics:
    width: int = 0
    dtype: str = ""               # tile dtype, "int8" or "int32"
    rows: int = 0
    padded_rows: int = 0          # rows added to round the batch up
    char_lanes: int = 0           # rows * width
    useful_char_lanes: int = 0    # sum of max(len_a, len_b) per row
    device_calls: int = 0
    device_wall_s: float = 0.0

    @property
    def padding_waste(self) -> float:
        """Fraction of character lanes that carry padding, not data."""
        total = self.char_lanes + self.padded_rows * self.width
        return 1.0 - self.useful_char_lanes / total if total else 0.0


@dataclasses.dataclass
class RunMetrics:
    n_rows: int = 0
    null_rows: int = 0
    fast_path_rows: int = 0       # both-empty or byte-equal: no device work
    one_empty_rows: int = 0
    device_rows: int = 0
    oracle_rows: int = 0          # scored on the host (native kernels or the oracle)
    encode_route: str = ""        # utils/encode.py: native_objects, native_utf8, numpy, encoded
    encode_wall_s: float = 0.0
    classify_wall_s: float = 0.0
    device_wall_s: float = 0.0
    finalize_wall_s: float = 0.0
    total_wall_s: float = 0.0
    buckets: Dict[int, BucketMetrics] = dataclasses.field(default_factory=dict)

    def bucket(self, width: int) -> BucketMetrics:
        if width not in self.buckets:
            self.buckets[width] = BucketMetrics(width=width)
        return self.buckets[width]

    @property
    def pairs_per_sec(self) -> float:
        return self.n_rows / self.total_wall_s if self.total_wall_s else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["pairs_per_sec"] = self.pairs_per_sec
        d["buckets"] = {
            w: {**dataclasses.asdict(b), "padding_waste": b.padding_waste}
            for w, b in self.buckets.items()
        }
        return d


class _Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt


def timer() -> _Timer:
    return _Timer()
