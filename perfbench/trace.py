"""Reduce a torch.profiler trace of the window, in memory, to what the
per-layer readers take: the device's ops (kernels, copies, sets) and the
host's, with the harness's own span around each call ("perfbench.call").

`Trace.busy_s` is the union of the device ops' intervals, its own
arithmetic. `breakdown` gives the device ops that took the most time and
the longest idle gaps of the device, each named by what the host was doing
at the gap's middle: the innermost host range open there, a `strsim.*` span
of the program (`RunMetrics.span`) or a torch op or CUDA runtime call inside
one; where none is open, the call the middle falls in, by its RunMetrics'
`encode_wall_s` and `classify_wall_s` (encode, then classify, then the
buckets and finalize), or the harness between calls.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

CALL_SPAN = "perfbench.call"


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, float, float, str]]  # (name, start us, end us, kind)
    host: List[Tuple[str, float, float]]         # (name, start us, end us)
    calls: List[Tuple[float, float]]             # the harness's call spans, us

    def busy_s(self) -> float:
        """Seconds during which at least one device op ran."""
        busy, end = 0.0, float("-inf")
        for lo, hi in sorted((s, e) for _, s, e, _ in self.device):
            if hi > end:
                busy += hi - max(lo, end)
                end = hi
        return busy / 1e6

    def kernel_s(self) -> float:
        """Summed device time of the kernels (copies and sets left out)."""
        return sum(e - s for _, s, e, kind in self.device if kind == "kernel") / 1e6


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def reduce(prof) -> Trace:
    """The profiler's raw kineto events (its FunctionEvent tree, which
    `prof.events()` builds, takes minutes for a window of thousands of
    calls), times in microseconds."""
    from torch.autograd import DeviceType

    device, host, calls = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        lo = e.start_ns() / 1e3
        hi = lo + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if name != CALL_SPAN:  # the span's own range on the device's timeline
                device.append((name, lo, hi, _kind(name)))
        elif name == CALL_SPAN:
            calls.append((lo, hi))
        else:
            host.append((name, lo, hi))
    calls.sort()
    return Trace(device=device, host=host, calls=calls)


def _call_phase(trace: Trace, rec, t: float) -> str:
    for i, (lo, hi) in enumerate(trace.calls):
        if lo <= t <= hi:
            rm = rec.calls[i].run_metrics if i < len(rec.calls) else None
            if rm is None:
                return "inside a call, no torch op"
            off = (t - lo) / 1e6
            if off < rm.encode_wall_s:
                return "encode, no torch op"
            if off < rm.encode_wall_s + rm.classify_wall_s:
                return "classify, no torch op"
            return "buckets or finalize, no torch op"
    return "between calls (harness)"


def _host_at(trace: Trace, t: float):
    best = None
    for name, lo, hi in trace.host:
        if lo <= t <= hi and (best is None or hi - lo < best[1]):
            best = (name, hi - lo)
    return best[0] if best else None


def breakdown(trace: Trace, rec, k: int = 10) -> dict:
    by_name = {}
    for name, lo, hi, _ in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
    spans = sorted((s, e) for _, s, e, _ in trace.device)
    gaps, end = [], trace.calls[0][0] if trace.calls else None
    for lo, hi in spans:
        if end is not None and lo > end:
            gaps.append((lo - end, end, lo))
        end = hi if end is None else max(end, hi)
    if trace.calls and end is not None and trace.calls[-1][1] > end:
        gaps.append((trace.calls[-1][1] - end, end, trace.calls[-1][1]))
    gaps.sort(reverse=True)
    named = []
    for dur, lo, hi in gaps[:k]:
        mid = (lo + hi) / 2
        named.append([_host_at(trace, mid) or _call_phase(trace, rec, mid), dur / 1e6])
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": named}
