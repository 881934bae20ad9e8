"""The "topk" call shape and its cell, `names.topk.jw.1m`, rehearsed on the
CPU: it checks correct traced and untraced with nothing of jax loaded and
changes no file that was there; each fault the program could have under the
timed path (scores finished in float32, the tie rule reversed, a tile of
candidates skipped, the queries' order not restored) and the float32 control
come out not correct; the shape's least work equals a count over every
pair; and the generator makes the same names from every seed."""
import collections
import hashlib
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _paths import ROOT
from perfbench import loadgen
from perfbench.generators import name_dictionary

CELL = "names.topk.jw.1m"
SCALE = 0.0001  # 100 queries a call against the whole dictionary
CHECKS = ["index_mismatches", "score_mismatches", "widest_gap", "failed_calls"]


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("topk") / "tree"
    root.mkdir()
    for name in ("BENCHMARK.json", "pyproject.toml"):
        shutil.copy(ROOT / name, root)
    skip = shutil.ignore_patterns("__pycache__")
    for name in ("perfbench", "strsim_tpu_torch"):
        shutil.copytree(ROOT / name, root / name, ignore=skip)
    if (ROOT / "build" / "strsim_tpu_torch").is_dir():  # the native library, built for this machine
        shutil.copytree(ROOT / "build" / "strsim_tpu_torch", root / "build" / "strsim_tpu_torch")
    return root, _digest(root / "perfbench")


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_rehearses_correct(tree, trace):
    root, before = tree
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELL, "--seed",
                           "2147483683", "--seconds", "0.3", "--trace", str(trace), "--rehearse",
                           "--scale", str(SCALE)], cwd=root, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res["checks"]) == CHECKS and all(v["value"] == 0 for v in res["checks"].values())
    assert "perfbench.shapes.topk" in proc.stderr
    if trace:  # the CPU has no device trace; its plain route pads nothing
        assert set(res["metrics"]) == {"topk.padding_waste", "topk.host_ns_per_pair",
                                       "topk.collect_ns_per_pair"}
        assert res["metrics"]["topk.padding_waste"]["value"] == 0.0
        assert res["metrics"]["topk.host_ns_per_pair"]["value"] > 0
    else:
        assert set(res["metrics"]) == {"setup_s"}
    after = _digest(root / "perfbench")
    assert {k: after[k] for k in before} == before  # no file that was there changed


@pytest.fixture
def harness(monkeypatch):
    """perfbench.run in this process, its environment restored after."""
    for key in ("STRSIM_TPU_TORCH_BUILD_DIR", "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH"):
        monkeypatch.setenv(key, "unset")
    from perfbench import run

    def go(seed=13):
        args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", "0.2", "--trace",
                          "0", "--rehearse", "--scale", str(SCALE)])
        return run.run(args)[0]
    return go


def _float32(real):
    def finish(*args, **kwargs):
        return real(*args, **kwargs).to(torch.float32).to(torch.float64)
    return finish


def _ties_reversed(real):
    def rank(scores, ids, k):  # equal scores: the higher index first
        out_ids, out_s = real(scores, -ids, k)
        return torch.where(torch.isinf(out_s), out_ids.new_full((), -1), -out_ids), out_s
    return rank


def _first_tile_skipped(real):
    def plain(q_codes, q_len, c_codes, c_len, c_ids, k, *args, **kwargs):
        return real(q_codes, q_len, c_codes[1024:], c_len[1024:], c_ids[1024:], k, *args, **kwargs)
    return plain


def _order_not_restored(real):
    def restore(idx, score, q_rows, ids, scores):
        real(idx, score, np.sort(q_rows), ids, scores)
    return restore


@pytest.mark.parametrize("module,name,fault,numbers", [
    ("topk_cuda", "finish_scores", _float32, ("score_mismatches",)),
    ("topk_cuda", "rank", _ties_reversed, ("index_mismatches",)),
    ("topk_cuda", "topk_plain", _first_tile_skipped, ("index_mismatches", "score_mismatches")),
    ("linkage", "to_query_order", _order_not_restored, ("index_mismatches", "score_mismatches")),
], ids=["float32", "ties_reversed", "tile_skipped", "order_not_restored"])
def test_a_fault_is_not_correct(harness, monkeypatch, module, name, fault, numbers):
    from strsim_tpu_torch.models import linkage
    from strsim_tpu_torch.ops import topk_cuda

    mod = {"topk_cuda": topk_cuda, "linkage": linkage}[module]
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    res = harness()
    assert not res["correct"] and res["failed"] == 0
    for number in numbers:
        assert res["checks"][number]["value"] > 0, number


def test_the_float32_control_is_not_correct():
    from perfbench.control import control_numbers

    for seed in (1, 2**31 + 7):
        numbers = control_numbers(CELL, seed, SCALE)
        assert not numbers["correct"]
        assert numbers["score_mismatches"] > 0 and numbers["index_mismatches"] > 0


def test_work_counts_every_pair():
    """`work` over the grid of lengths equals the same counts summed pair by
    pair, each pair the row conventions leave (both sides non-empty, not
    equal), and each candidate's table build once."""
    from perfbench.roofline import _counts
    from perfbench.shapes import topk

    w = loadgen.load(loadgen.manifest(), CELL, 5, SCALE)
    for inp in w.inputs:
        inp.queries[:3] = [None, "", inp.candidates[7]]
        inp.candidates[:2] = [None, "é" + inp.candidates[1]]
        inp._work = None
        pairs = [(x, y) for x in inp.queries for y in inp.candidates
                 if x and y and x != y]
        la = np.array([len(x) for x, _ in pairs])
        lb = np.array([len(y) for _, y in pairs])
        ops = (_counts.jaro(la, lb) + _counts.prefix(la, lb)
               + _counts.jaro_word_steps(la, lb)).sum()
        ops += sum(len(y) for y in inp.candidates if y)
        nbytes = 16 * len(inp.queries) * inp.k
        for col in (inp.queries, inp.candidates):
            nbytes += sum(4 + len(x) * (1 if x.isascii() else 4) for x in col if x is not None)
            nbytes += 4 * sum(x is None for x in col)
        assert topk.work(w.measures, inp) == (float(nbytes), float(ops))
        assert inp.rows == len(inp.queries) * len(inp.candidates)


def test_every_seed_makes_the_same_names():
    config = loadgen.HERE / "configs" / "genealogy_name_dictionary.json"
    params = loadgen.read_json(config)["params"]
    names = name_dictionary.names(params["rows"])
    assert len(names) == 1105 and len(set(names)) == 1105
    assert all(x and x.isascii() and len(x) <= 27 for x in names)
    cols = [name_dictionary.generate(1105 * 3 + 17, seed, **params) for seed in (7, 2**40 + 3)]
    for queries, dictionary in cols:
        assert sorted(dictionary) == sorted(names)
        counts = collections.Counter(queries.tolist())
        assert set(counts) == set(names) and set(counts.values()) == {3, 4}
    assert list(cols[0][0]) != list(cols[1][0]) and list(cols[0][1]) != list(cols[1][1])


def test_the_sample_is_stratified_by_length():
    from perfbench.shapes import topk

    queries = ["a" * (i % 9 + 1) for i in range(5000)] + [None] * 4
    rows = topk.sample(queries, 1024, np.random.default_rng(3))
    assert rows.size == 1024 and np.unique(rows).size == 1024 and (np.diff(rows) > 0).all()
    lengths = collections.Counter("null" if queries[r] is None else len(queries[r]) for r in rows)
    assert lengths["null"] == 4 and min(v for k, v in lengths.items() if k != "null") >= 1024 // 10
