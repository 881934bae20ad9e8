"""The harness, rehearsed on the CPU at a small scale: every cell runs and
checks correct with nothing of jax or the JAX package loaded; a run without
a card, or without the program, prints no result; the roofline bound reads
the measures and the lengths and not the routes; each fault a cell can have,
planted under the timed path, and the float32 control come out not correct;
and a cell, configuration, generator and metric added as new files plus
manifest entries run without an edit to any file that was there."""
import hashlib
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _paths import ROOT

CELLS = {"names.five.1m": 0.002, "names.levenshtein.1m": 0.002}
FORBIDDEN = {"jax", "jaxlib", "flax", "strsim_tpu", "bench", "bench_torch"}


def _cli(cwd, cell, scale, trace=0, rehearse=True, seconds="0.5"):
    cmd = [sys.executable, "perfbench/run.py", "--workload", cell, "--seed", "2147483659",
           "--seconds", seconds, "--trace", str(trace)]
    if rehearse:
        cmd += ["--rehearse", "--scale", str(scale)]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=600)


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_rehearses_correct(cell):
    res = _result(_cli(ROOT, cell, CELLS[cell], trace=1))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"] if cell in m.get("workloads", [cell])}
    on_cpu = {m["name"] for m in bench["per_layer"] if m["source"] != "device_trace"}
    assert set(res["metrics"]) == listed & on_cpu  # no device trace on the CPU


def test_no_jax_after_a_run():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n"
            "from perfbench import run\n"
            "res, _ = run.run(run.parse(['--workload', 'names.levenshtein.1m', '--seed', '3', "
            "'--seconds', '0.3', '--rehearse', '--scale', '0.002']))\n"
            "print(json.dumps([res['correct'], sorted({m.split('.')[0] for m in sys.modules})]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and "strsim_tpu_torch" in loaded and not FORBIDDEN & set(loaded)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _cli(ROOT, "names.five.1m", 0, rehearse=False)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rehearse in (False, True):
        proc = _cli(tmp_path, "names.five.1m", 0.002, rehearse=rehearse)
        assert proc.returncode != 0 and not proc.stdout.strip()


@pytest.fixture
def harness(monkeypatch):
    """perfbench.run in this process, its environment restored after."""
    for key in ("STRSIM_TPU_TORCH_BUILD_DIR", "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH"):
        monkeypatch.setenv(key, "unset")
    from perfbench import run

    def go(cell="names.five.1m", trace=0, fault=None, seed=11):
        args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.3",
                          "--trace", str(trace), "--rehearse", "--scale", str(CELLS[cell])])
        return run.run(args, fault=fault)
    return go


def test_roofline_bound_reads_measures_and_lengths_only(harness, monkeypatch):
    import strsim_tpu_torch as st
    from perfbench.metrics import kernels_roofline
    from perfbench.roofline._peaks import PEAKS
    from strsim_tpu_torch.ops.stats import stat_routes

    five = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
    forced = st.StrsimConfig(levenshtein_impl="pallas", jaro_impl="pallas")
    assert stat_routes(five, 31, torch.int8, forced.impls()) != stat_routes(five, 31, torch.int8)
    bounds = []
    for config in (st.StrsimConfig(), forced):
        monkeypatch.setattr(st.config, "_CONFIG", config)
        res, rec = harness(trace=1)
        assert res["correct"]
        rec.calls = rec.calls[:2]  # one call on each input, whatever the pace
        rec.peaks = PEAKS["NVIDIA H100 80GB HBM3"]
        bounds.append(kernels_roofline.bound_s(rec))
    assert bounds[0] == bounds[1] and bounds[0][0] > 0
    b = bounds[0][0]
    assert kernels_roofline.share(b, b) == pytest.approx(100.0)
    for t in np.linspace(b, 50 * b, 30):
        assert kernels_roofline.share(b, t) <= 100.0 + 1e-9


def _stale(entry):
    first = []

    def broken(inp):
        out = entry(inp)
        first.append(out)
        return first[0]  # the state left as it was after the first call
    return broken


def test_faults_come_out_not_correct(harness, monkeypatch):
    from strsim_tpu_torch.models import pipeline

    res, _ = harness()
    assert res["correct"]

    res, _ = harness(fault=_stale)
    assert not res["correct"] and res["checks"]["score_mismatches"]["value"] > 0

    real_rows = pipeline.bucket_rows

    def half(idx, la, lb, cfg):  # half of each bucket's rows left out
        return {w: sel[: (sel.size + 1) // 2] for w, sel in real_rows(idx, la, lb, cfg).items()}
    monkeypatch.setattr(pipeline, "bucket_rows", half)
    res, _ = harness()
    assert not res["correct"] and res["checks"]["widest_gap"]["value"] == 1.0
    monkeypatch.setattr(pipeline, "bucket_rows", real_rows)

    real_stats = pipeline.compute_stats

    def altered(a, b, len_a, len_b, measures, impls=None):  # lev_d off by one in one bucket
        out = real_stats(a, b, len_a, len_b, measures, impls)
        if a.shape[1] == 15:
            out["lev_d"] = out["lev_d"] + 1
        return out
    monkeypatch.setattr(pipeline, "compute_stats", altered)
    res, _ = harness()
    assert not res["correct"] and res["checks"]["score_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_float32_control_is_not_correct(cell):
    from perfbench.control import control_numbers

    for seed in (1, 2, 2**31 + 3):
        numbers = control_numbers(cell, seed, CELLS[cell])
        assert not numbers["correct"] and numbers["score_mismatches"] > 0


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_files(tmp_path):
    for name in ("BENCHMARK.json", "pyproject.toml"):
        shutil.copy(ROOT / name, tmp_path)
    skip = shutil.ignore_patterns("__pycache__")
    for name in ("perfbench", "strsim_tpu_torch"):
        shutil.copytree(ROOT / name, tmp_path / name, ignore=skip)
    if (ROOT / "build" / "strsim_tpu_torch").is_dir():  # the native library, built for this machine
        shutil.copytree(ROOT / "build" / "strsim_tpu_torch", tmp_path / "build" / "strsim_tpu_torch")
    before = _digest(tmp_path / "perfbench")
    pb = tmp_path / "perfbench"
    (pb / "generators" / "short_words.py").write_text(
        "import numpy as np\n\n\n"
        "def generate(n, seed, *, letters, max_len):\n"
        "    rng = np.random.default_rng(seed)\n"
        "    def col():\n"
        "        lens = rng.integers(0, max_len + 1, n)\n"
        "        return np.array([''.join(rng.choice(list(letters), k)) for k in lens], dtype=object)\n"
        "    return col(), col()\n")
    (pb / "configs" / "short_words.json").write_text(json.dumps(
        {"generator": "short_words", "params": {"letters": "abcz", "max_len": 40}, "reduced": []}))
    (pb / "traffic" / "three.json").write_text(json.dumps(
        {"shape": "pairs", "measures": ["levenshtein", "osa", "hamming"], "pairs_per_call": 300000,
         "batches": 3, "check_rows_per_stratum": 30}))
    (pb / "metrics" / "extra.calls.py").write_text(
        "def read(rec):\n    return float(len(rec.phased())) if rec.phased() else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "short_words", "source": "https://example.org/short",
                             "file": "perfbench/configs/short_words.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "words.three", "config": "short_words", "traffic": "three",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append(  # the new cell holds pairs_per_s end to end, its reader a file
        {"name": "pairs_per_s", "unit": "pairs/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["words.three"]})
    bench["per_layer"].append({"name": "extra.calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "API", "moves": "pairs_per_s",
                               "workloads": ["words.three"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traced = _result(_cli(tmp_path, "words.three", 0.001, trace=1))
    plain = _result(_cli(tmp_path, "words.three", 0.001, trace=0))
    assert traced["correct"] and plain["correct"]
    assert traced["metrics"]["extra.calls"]["value"] >= 1 and "pairs_per_s" in plain["metrics"]
    after = _digest(pb)
    assert {k: after[k] for k in before} == before  # no file that was there changed
