"""Call shapes: the "pairs" shape gives each cell the inputs, check rows,
roofline work and widths that the harness gave before it knew shapes (the
constants below were recorded on the harness that had the pairs code in
`loadgen.py`, `check.py` and `run.py`); the harness takes the call's shape
from the shape's module alone, so that a shape added as files runs, checks
and fails with its own numbers; and the roofline bound reads the shape's
`work`."""
import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from _paths import ROOT
from perfbench import loadgen
from perfbench.record import Call, Record
from perfbench.roofline._peaks import PEAKS

SCALE = 0.002
# (cell, seed): digests of the inputs' strings and nulls and of the check
# rows, and each input's roofline (bytes, operations)
PINNED = {
    ("names.five.1m", 7): ("10ae11f3a7d47698", "113d72eec85428d4", (81797.0, 468362.0)),
    ("names.five.1m", 2147483659): ("db6d93257a5b3c53", "d2f8a07a0cf9a10e", (81797.0, 468362.0)),
    ("names.levenshtein.1m", 7): ("10ae11f3a7d47698", "113d72eec85428d4", (58229.0, 299402.0)),
    ("names.levenshtein.1m", 2147483659): ("db6d93257a5b3c53", "d2f8a07a0cf9a10e",
                                           (58229.0, 299402.0)),
}
WIDTHS = {7: True, 15: True, 23: True, 31: True}


def _digest(obj):
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:16]


@pytest.mark.parametrize("cell,seed", sorted(PINNED))
def test_pairs_reads_as_before_shapes(cell, seed):
    import strsim_tpu_torch as st

    w = loadgen.load(loadgen.manifest(), cell, seed, SCALE)
    w.shape.select(w, seed)
    inputs, rows, work = PINNED[(cell, seed)]
    assert w.shape.__name__ == "perfbench.shapes.pairs" and len(w.inputs) == 2
    assert _digest([[inp.a, inp.b] for inp in w.inputs]) == inputs
    assert _digest([inp.check_rows.tolist() for inp in w.inputs]) == rows
    assert [w.shape.work(w.measures, inp) for inp in w.inputs] == [work, work]
    assert all(w.shape.widths(inp, st.get_config()) == WIDTHS for inp in w.inputs)


def _fake_work(measures, inp):
    return 3.35e12 * (1 + inp.rows % 7), 0.0  # a second of HBM bytes, and more


@pytest.mark.parametrize("cell", ["names.five.1m", "names.levenshtein.1m"])
def test_roofline_reads_the_shapes_work(cell, monkeypatch):
    from perfbench.metrics import kernels_roofline
    from perfbench.shapes import pairs

    w = loadgen.load(loadgen.manifest(), cell, 5, SCALE)
    monkeypatch.setattr(pairs, "work", _fake_work)

    def no_rows(self):
        raise AssertionError("the bound read Input.device_rows")
    monkeypatch.setattr(pairs.Input, "device_rows", no_rows)
    calls = [Call(input=k % 2, rows=w.inputs[k % 2].rows, wall_s=0.1) for k in range(3)]
    calls.append(Call(input=1, rows=w.inputs[1].rows, wall_s=0.1, failed=True))
    rec = Record(workload=w, setup_s=0.0, window_s=1.0, calls=calls,
                 peaks=PEAKS["NVIDIA H100 80GB HBM3"])
    want = sum(_fake_work(w.measures, w.inputs[c.input])[0] for c in calls[:3]) / 3.35e12
    assert kernels_roofline.bound_s(rec) == (pytest.approx(want, rel=1e-12), "bytes")


# A call shape of its own: one name of the corpus, drawn from the seed,
# against a column, through compute_many's broadcast of a str side.
LITERAL = '''"""Call shape "literal": one name against a column."""
import numpy as np

from perfbench import check
from perfbench.loadgen import child_seed, scaled
from perfbench.roofline import _bound

LIMITS = {"literal_mismatches": 0, "literal_widest_gap": 0.0, "literal_failed_calls": 0}


class Input:
    def __init__(self, literal, column):
        self.literal, self.column, self.check_rows = literal, column, None
        self.rows = len(column)


def inputs(gen, params, traffic, seed, scale):
    n = scaled(traffic["rows_per_call"], scale, 64)
    out = []
    for k in range(traffic["batches"]):
        a, b = gen(n, child_seed(seed, 5, k), **params)
        names = [x for x in a.tolist() if x]
        pick = np.random.default_rng(child_seed(seed, 6, k)).integers(len(names))
        out.append(Input(names[pick], b.tolist()))
    return out


def select(workload, seed):
    rng = np.random.default_rng(child_seed(seed, 7))
    for inp in workload.inputs:
        inp.check_rows = check.select([inp.literal] * inp.rows, inp.column,
                                      workload.traffic["check_rows_per_stratum"], rng)


def entry(st, measures, cfg, traced):
    if traced:
        from strsim_tpu_torch.models.pipeline import compute_scores
        from strsim_tpu_torch.utils.metrics import RunMetrics

        def call(inp):
            rm = RunMetrics()
            res = compute_scores([inp.literal], inp.column, measures, config=cfg, metrics=rm)
            return {m: v for m, (v, _) in res.items()}, rm
    else:
        def call(inp):
            return st.compute_many(measures, inp.literal, inp.column, config=cfg), None
    return call


def keep(out, inp, measures):
    return np.stack([out[m][inp.check_rows] for m in measures])


def reference(workload, dtype=np.float64):
    return {k: check.reference_scores(workload.measures, [inp.literal] * len(inp.check_rows),
                                      [inp.column[i] for i in inp.check_rows], dtype)
            for k, inp in enumerate(workload.inputs)}


def compare(got, want, failed_calls):
    bad, gap = 0, 0.0
    for k, scores in got:
        n, g = check.exact(scores, want[k])
        bad, gap = bad + n, max(gap, g)
    return {"literal_mismatches": bad, "literal_widest_gap": gap, "literal_failed_calls": failed_calls}


def _device(inp):
    rows = [y for y in inp.column if y and y != inp.literal]
    return ([len(inp.literal)] * len(rows), [len(y) for y in rows],
            [inp.literal.isascii() and y.isascii() for y in rows])


def work(measures, inp):
    return _bound.work(measures, *_device(inp))


def widths(inp, cfg):
    la, lb, _ = _device(inp)
    return {cfg.bucket_for(max(x, y)): True for x, y in zip(la, lb)}
'''


def _tree_digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _copy(dst):
    dst.mkdir()
    for name in ("BENCHMARK.json", "pyproject.toml"):
        shutil.copy(ROOT / name, dst)
    skip = shutil.ignore_patterns("__pycache__")
    for name in ("perfbench", "strsim_tpu_torch"):
        shutil.copytree(ROOT / name, dst / name, ignore=skip)
    if (ROOT / "build" / "strsim_tpu_torch").is_dir():  # the native library, built for this machine
        shutil.copytree(ROOT / "build" / "strsim_tpu_torch", dst / "build" / "strsim_tpu_torch")


def _add_literal_shape(root, shape_source):
    pb = root / "perfbench"
    (pb / "shapes" / "literal.py").write_text(shape_source)
    (pb / "traffic" / "literal.five.json").write_text(json.dumps(
        {"shape": "literal", "measures": ["levenshtein", "jaro", "jaro_winkler", "jaccard",
                                          "sorensen_dice"],
         "rows_per_call": 300000, "batches": 2, "check_rows_per_stratum": 40}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "names.literal", "config": "genealogy_names",
                               "traffic": "literal.five", "chips": 1, "why": "a test"})
    bench["end_to_end"].append(  # the new cell holds pairs_per_s end to end, its reader a file
        {"name": "pairs_per_s", "unit": "pairs/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["names.literal"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _rehearse(root, trace, seed="2147483671"):
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "names.literal",
                           "--seed", seed, "--seconds", "0.3", "--trace", str(trace),
                           "--rehearse", "--scale", "0.001"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.fixture(scope="module")
def literal_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("literal") / "tree"
    _copy(root)
    before = _tree_digest(root / "perfbench")
    _add_literal_shape(root, LITERAL)
    return root, before


@pytest.mark.parametrize("trace", [0, 1])
def test_a_shape_added_as_files(literal_tree, trace):
    root, before = literal_tree
    res, err = _rehearse(root, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res["checks"]) == ["literal_mismatches", "literal_widest_gap", "literal_failed_calls"]
    assert all(v["value"] == 0 for v in res["checks"].values())
    assert "perfbench.shapes.literal" in err
    if trace == 0:
        assert res["metrics"]["pairs_per_s"]["value"] > 0
    after = _tree_digest(root / "perfbench")
    assert {k: after[k] for k in before} == before  # no file that was there changed


def test_a_fault_in_the_added_shape_is_not_correct(literal_tree, tmp_path):
    root, _ = literal_tree
    broken = tmp_path / "broken"
    shutil.copytree(root, broken, ignore=shutil.ignore_patterns("__pycache__"))
    real = "return st.compute_many(measures, inp.literal, inp.column, config=cfg), None"
    assert real in LITERAL
    (broken / "perfbench" / "shapes" / "literal.py").write_text(LITERAL.replace(
        real, "return st.compute_many(measures, inp.literal[:-1] or 'q', inp.column, config=cfg), None"))
    res, err = _rehearse(broken, 0)
    assert not res["correct"]
    assert res["checks"]["literal_mismatches"]["value"] > 0
    assert res["checks"]["literal_mismatches"]["limit"] == 0
    assert "check literal_mismatches:" in err


def test_the_control_of_an_added_shape_is_not_correct(literal_tree):
    root, _ = literal_tree
    proc = subprocess.run([sys.executable, "perfbench/control.py", "--workload", "names.literal",
                           "--seeds", "1,2147483671", "--scale", "0.001"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in proc.stdout.strip().splitlines():
        numbers = json.loads(line)
        assert not numbers["correct"] and numbers["literal_mismatches"] > 0
