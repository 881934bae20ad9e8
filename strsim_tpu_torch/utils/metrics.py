"""Run metrics: rows by disposition (null / fast path / device / host),
per-bucket occupancy and padding waste, and where each call's time goes as
a tree of named spans. The pipeline fills a RunMetrics when given one;
collection costs nothing when off (`maybe_span` then hands out one shared
no-op context).

A span (`RunMetrics.span(name, **attrs)`) is one piece of work of one call:
its name, the index of its parent span, the call it belongs to, its start
and end on `time.perf_counter_ns` and its attrs. While a torch profiler
records, the span is also a range of the profiler's trace, on the same clock
as the device's kernels and copies. The range is a function-scope record, as
an aten op's is: a user-scope `torch.profiler.record_function` range would
also put a range of its own on the device's timeline, around the device ops
it launched. The phase fields (`encode_wall_s` .. `total_wall_s` and
`BucketMetrics.device_wall_s`) are the summed durations of their spans
(`PHASES`), filled as each span closes."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import torch

# span name -> the RunMetrics field that sums its durations. A bucket's
# device_wall_s is its stage plus its download (both carry the width).
PHASES = {
    "strsim.encode": "encode_wall_s",
    "strsim.classify": "classify_wall_s",
    "strsim.stage": "device_wall_s",
    "strsim.collect.download": "device_wall_s",
    "strsim.finalize": "finalize_wall_s",
    "strsim.call": "total_wall_s",
}

_OFF = contextlib.nullcontext()


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
class Span:
    name: str
    parent: int                   # index in RunMetrics.spans, -1 at the top
    call: int                     # index of the compute_scores call, 0 first
    start_ns: int = 0             # time.perf_counter_ns
    end_ns: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


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
    calls: int = 0                # compute_scores calls given this RunMetrics
    spans: List[Span] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._open: List[int] = []              # indices of the spans still open
        self._phase_ns: Dict[str, int] = {}     # field -> its spans' summed ns
        self._bucket_ns: Dict[int, int] = {}    # width -> stage + download ns

    def bucket(self, width: int) -> BucketMetrics:
        if width not in self.buckets:
            self.buckets[width] = BucketMetrics(width=width)
        return self.buckets[width]

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time the block as a span named `name`, the child of the innermost
        span open, in the current call."""
        rec = Span(name, self._open[-1] if self._open else -1, self.calls - 1, attrs=attrs)
        self._open.append(len(self.spans))
        self.spans.append(rec)
        profiled = torch._C._autograd._profiler_enabled()
        with (torch._C._profiler._RecordFunctionFast(name) if profiled else _OFF):
            rec.start_ns = time.perf_counter_ns()
            try:
                yield rec
            finally:
                rec.end_ns = time.perf_counter_ns()
                self._open.pop()
                self._close(rec)

    def _close(self, rec: Span) -> None:
        field = PHASES.get(rec.name)
        if field is None:
            return
        # summed in whole ns, so a field is exactly its spans' sum, in any order
        self._phase_ns[field] = self._phase_ns.get(field, 0) + rec.ns
        setattr(self, field, self._phase_ns[field] / 1e9)
        if field == "device_wall_s":
            width = rec.attrs["width"]
            self._bucket_ns[width] = self._bucket_ns.get(width, 0) + rec.ns
            self.bucket(width).device_wall_s = self._bucket_ns[width] / 1e9

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def span_s(self, name: str) -> float:
        """Summed duration of the spans named `name`, seconds."""
        return sum(s.ns for s in self.spans if s.name == name) / 1e9

    def self_s(self, name: str) -> float:
        """Summed duration of the spans named `name` less what their direct
        children cover, seconds."""
        covered = {}
        for s in self.spans:
            if s.parent >= 0:
                covered[s.parent] = covered.get(s.parent, 0) + s.ns
        return sum(s.ns - covered.get(i, 0) for i, s in enumerate(self.spans)
                   if s.name == name) / 1e9

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


def maybe_span(metrics, name: str, **attrs):
    """`metrics.span(name, **attrs)`, or one shared no-op context when
    metrics is None: no clock read, no record, no profiler range."""
    return _OFF if metrics is None else metrics.span(name, **attrs)
