"""The pipeline's spans (utils/metrics.py, models/pipeline.py) on the CPU:
every span nests in its parent and in its call, children in order, with the
call tree each piece of work belongs to; the call's own time outside its
parts is small; the phase fields are the sums of their spans, exactly;
without a RunMetrics no span, clock read or profiler range is made and the
scores are byte-equal; under torch.profiler the spans are ranges of the
trace, nested as in memory and on no device timeline; and the benchmark's
readers of the spans and the staging counter read a rehearsed run."""
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from strsim_tpu_torch import config as torch_config
from strsim_tpu_torch.models import pipeline as tpipe
from strsim_tpu_torch.utils import metrics as tmetrics
from strsim_tpu_torch.utils.metrics import PHASES, RunMetrics

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")

# name -> the name of its parent span (None at the top of a call)
TREE = {
    "strsim.call": None,
    "strsim.encode": "strsim.call",
    "strsim.classify": "strsim.call",
    "strsim.host_rows": "strsim.call",
    "strsim.partition": "strsim.call",
    "strsim.stage": "strsim.call",
    "strsim.stage.alloc": "strsim.stage",
    "strsim.stage.pack": "strsim.stage",
    "strsim.enqueue": "strsim.stage",
    "strsim.collect": "strsim.call",
    "strsim.collect.download": "strsim.collect",
    "strsim.finalize": "strsim.collect",
    "strsim.release": "strsim.call",
}
READERS = ("partition.ns_per_pair", "stage.sort_ns_per_pair", "stage.alloc_ns_per_pair",
           "stage.pack_ns_per_pair", "enqueue.ns_per_pair", "collect.download_ns_per_pair",
           "call.self_ns_per_pair", "stage.bytes_per_pair", "release.ns_per_pair")


def _columns(n, seed=5):
    """Surname-like ASCII rows of 0..27 chars, with null, equal and
    one-empty rows and a few past the short ladder."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    a = ["".join(rng.choice(letters, k)) for k in rng.integers(1, 28, n)]
    b = ["".join(rng.choice(letters, k)) for k in rng.integers(1, 28, n)]
    for i in range(0, n, 97):
        b[i] = a[i]
    for i in range(1, n, 89):
        a[i] = None
    for i in range(2, n, 83):
        b[i] = ""
    for i in range(3, n, 4001):
        a[i], b[i] = "q" * 70, "r" * 66
    return a, b


@pytest.fixture(scope="module")
def cfg():
    return torch_config.StrsimConfig(device="cpu", host_short_circuit_rows=8)


@pytest.fixture(scope="module")
def traced(cfg):
    """One RunMetrics over three calls: a 20,000-row five, a 5-row five
    (host rows) and a 3,000-row levenshtein; with their scores."""
    rm = RunMetrics()
    outs = []
    for (a, b), measures in ((_columns(20000), FIVE), (_columns(5, 6), FIVE),
                             (_columns(3000, 7), ("levenshtein",))):
        outs.append(tpipe.compute_scores(a, b, measures, config=cfg, metrics=rm))
    return rm, outs


def test_each_call_is_one_tree(traced):
    rm, _ = traced
    assert rm.calls == 3
    roots = [i for i, s in enumerate(rm.spans) if s.parent == -1]
    assert [rm.spans[i].name for i in roots] == ["strsim.call"] * 3
    assert [rm.spans[i].call for i in roots] == [0, 1, 2]
    for i, s in enumerate(rm.spans):
        assert s.name in TREE and s.start_ns <= s.end_ns
        root = rm.spans[roots[s.call]]
        assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
        if s.parent == -1:
            continue
        parent = rm.spans[s.parent]
        assert s.parent < i and parent.name == TREE[s.name] and parent.call == s.call
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    names = [{s.name for s in rm.spans if s.call == c} for c in range(3)]
    assert names[0] == set(TREE) - {"strsim.host_rows"}  # a 70-char row is a device row
    assert names[1] == {"strsim.call", "strsim.encode", "strsim.classify", "strsim.host_rows",
                        "strsim.partition", "strsim.release"}
    assert names[2] == names[0]


def test_children_in_order(traced):
    rm, _ = traced
    children = {}
    for i, s in enumerate(rm.spans):
        children.setdefault(s.parent, []).append(i)
    for parent, kids in children.items():
        for before, after in zip(kids, kids[1:]):
            assert rm.spans[before].end_ns <= rm.spans[after].start_ns, (parent, before, after)
    first = [rm.spans[i].name for i in children[0]]
    assert first[:3] == ["strsim.encode", "strsim.classify", "strsim.partition"]
    stages = [rm.spans[i].attrs["width"] for i in children[0] if rm.spans[i].name == "strsim.stage"]
    collects = [rm.spans[i].attrs["width"] for i in children[0]
                if rm.spans[i].name == "strsim.collect"]
    assert stages == collects and len(stages) >= 3  # every bucket staged before any collect
    assert first.index("strsim.collect") > max(i for i, n in enumerate(first) if n == "strsim.stage")
    assert first[-1] == "strsim.release"
    for i in children[0]:
        if rm.spans[i].name == "strsim.stage":
            assert [rm.spans[k].name for k in children[i]] == [
                "strsim.stage.alloc", "strsim.stage.pack", "strsim.enqueue"]


def test_call_self_time_is_small(traced):
    rm, _ = traced
    call = next(s for s in rm.spans if s.name == "strsim.call" and s.call == 0)
    covered = sum(s.ns for s in rm.spans if s.parent == rm.spans.index(call))
    assert (call.ns - covered) < 0.05 * call.ns
    assert rm.self_s("strsim.call") == sum(
        s.ns - sum(k.ns for k in rm.spans if k.parent == i)
        for i, s in enumerate(rm.spans) if s.name == "strsim.call") / 1e9


def test_phase_fields_are_the_sums_of_their_spans(traced):
    rm, _ = traced
    fields = {}
    for name, field in PHASES.items():
        fields.setdefault(field, []).append(name)
    assert set(fields) == {"encode_wall_s", "classify_wall_s", "device_wall_s", "finalize_wall_s",
                           "total_wall_s"}
    for field, names in fields.items():
        ns = sum(s.ns for s in rm.spans if s.name in names)
        assert ns > 0 and getattr(rm, field) == ns / 1e9, field
    for width, bm in rm.buckets.items():
        ns = sum(s.ns for s in rm.spans
                 if s.name in ("strsim.stage", "strsim.collect.download") and s.attrs["width"] == width)
        assert bm.device_wall_s == ns / 1e9 and bm.rows > 0, width
    assert rm.span_s("strsim.call") == rm.total_wall_s


def test_stage_bytes_count_the_padded_staging(traced):
    rm, _ = traced
    want = sum((bm.rows + bm.padded_rows) * (2 * bm.width * np.dtype(bm.dtype).itemsize + 8)
               for bm in rm.buckets.values())
    assert set(rm.counters) == {"stage.bytes"}
    assert rm.counters["stage.bytes"] == want and want > 0


def test_as_dict_holds_spans_and_counters(traced):
    rm, _ = traced
    d = rm.as_dict()
    assert d["calls"] == 3 and len(d["spans"]) == len(rm.spans)
    assert d["spans"][0] == {"name": "strsim.call", "parent": -1, "call": 0,
                             "start_ns": rm.spans[0].start_ns, "end_ns": rm.spans[0].end_ns,
                             "attrs": {}}
    assert d["counters"] == rm.counters
    json.dumps(d)


def test_off_makes_no_span(traced, cfg, monkeypatch):
    """metrics=None: RunMetrics.span is never entered, the clock is not read,
    no profiler range is made, and the scores are byte-equal."""
    _, outs = traced

    def refuse(*args, **kwargs):
        raise AssertionError("reached with metrics=None")
    monkeypatch.setattr(RunMetrics, "span", refuse)
    monkeypatch.setattr(tmetrics, "time", types.SimpleNamespace(perf_counter_ns=refuse))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for (a, b), measures, want in ((_columns(20000), FIVE, outs[0]),
                                       (_columns(5, 6), FIVE, outs[1])):
            got = tpipe.compute_scores(a, b, measures, config=cfg)
            for m in measures:
                assert got[m][0].tobytes() == want[m][0].tobytes(), m
                assert got[m][1].tobytes() == want[m][1].tobytes(), m
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert names and not any(n.startswith("strsim.") for n in names)


def test_off_takes_one_shared_context():
    assert tmetrics.maybe_span(None, "strsim.call") is tmetrics.maybe_span(None, "strsim.stage",
                                                                           width=7)


def test_profiler_ranges_nest_as_in_memory(cfg):
    """Under torch.profiler each span is a host range of the trace, named as
    in memory, enclosing its span's clock reads, nested as the spans are;
    none lies on a device's timeline."""
    from torch.autograd import DeviceType

    a, b = _columns(3000, 8)
    rm = RunMetrics()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tpipe.compute_scores(a, b, FIVE, config=cfg, metrics=rm)
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("strsim.")]
    assert all(e.device_type() == DeviceType.CPU for e in events)
    ranges = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events),
                    key=lambda r: (r[0], -r[1]))
    assert [r[2] for r in ranges] == [s.name for s in rm.spans]
    for s, (lo, hi, _) in zip(rm.spans, ranges):
        assert hi - lo >= s.ns and hi - lo <= s.ns + 5_000_000
        if s.parent >= 0:
            plo, phi, _ = ranges[s.parent]
            assert plo <= lo and hi <= phi


def test_spans_reused_across_calls_share_their_call_index(cfg):
    rm = RunMetrics()
    a, b = _columns(600, 9)
    for _ in range(4):
        tpipe.compute_scores(a, b, ("jaro",), config=cfg, metrics=rm)
    per_call = [[s.name for s in rm.spans if s.call == c] for c in range(4)]
    assert rm.calls == 4 and all(names == per_call[0] for names in per_call)
    assert rm.n_rows == 2400 and rm.total_wall_s == rm.span_s("strsim.call")


_REHEARSAL = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import run, trace
from perfbench.metrics import _spans

res, rec = run.run(run.parse(['--workload', 'names.levenshtein.1m', '--seed', '2147483659',
                              '--seconds', '0.5', '--trace', '1', '--rehearse', '--scale', '0.002']))
readers = {{name: run.load_reader(name).read(rec) for name in {readers!r}}}
rows = sum(c.rows for c in rec.phased())
staged = sum((bm.rows + bm.padded_rows) * (2 * bm.width * (1 if bm.dtype == 'int8' else 4) + 8)
             for c in rec.phased() for bm in c.run_metrics.buckets.values())
part = [(lo, hi) for name, lo, hi in rec.trace.host if name == 'strsim.partition']
lo, hi = max(part, key=lambda r: r[1] - r[0])
device = [('k_before', lo - 1.0, lo, 'kernel'), ('k_after', hi, hi + 1.0, 'kernel')]
named = trace.breakdown(trace.Trace(device=device, host=rec.trace.host, calls=rec.trace.calls), rec)
gap = [n for n, s in named['idle_gaps'] if abs(s - (hi - lo) / 1e6) < 1e-9]
print(json.dumps({{'correct': res['correct'], 'line': sorted(res['metrics']), 'readers': readers,
                  'bytes_per_pair': staged / rows, 'gap': gap,
                  'loaded': sorted({{m.split('.')[0] for m in sys.modules}})}}))
"""


@pytest.fixture(scope="module")
def rehearsal():
    code = _REHEARSAL.format(root=str(ROOT), readers=READERS)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_rehearsed_run(rehearsal, name):
    assert rehearsal["correct"] and "jax" not in rehearsal["loaded"]
    assert name in rehearsal["line"]
    if name == "stage.sort_ns_per_pair":  # no stage sort remains: bucket_rows orders the rows
        assert rehearsal["readers"][name] == 0.0
    else:
        assert rehearsal["readers"][name] > 0


def test_stage_bytes_reader_matches_the_buckets(rehearsal):
    assert rehearsal["readers"]["stage.bytes_per_pair"] == pytest.approx(
        rehearsal["bytes_per_pair"], rel=1e-12)


def test_breakdown_names_a_gap_by_the_innermost_span(rehearsal):
    assert rehearsal["gap"] == ["strsim.partition"]
