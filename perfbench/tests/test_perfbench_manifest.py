"""BENCHMARK.json keeps to the contract's shapes and characters, and every
name in it has the files the harness finds by that name."""
import json
import re

from _paths import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        names.append(c["name"])
    configs = set(names)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert len(cells) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    assert {w["config"] for w in BENCH["workloads"]} == configs
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(e2e[m["moves"]].get("workloads", cells))
    names += [m["name"] for m in metrics] + list(cells)
    assert len(names) == len(set(names))


def test_every_name_has_its_files():
    here = ROOT / "perfbench"
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
        config = json.loads((here / "configs" / f"{w['config']}.json").read_text())
        assert (here / "generators" / f"{config['generator']}.py").is_file()
        assert (here / "shapes" / f"{traffic['shape']}.py").is_file()
        for m in traffic["measures"]:
            assert (here / "reference" / f"{m}.py").is_file()
            assert (here / "roofline" / f"{m}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:  # each cell reports setup_s, another end-to-end metric and a per-layer one
        e2e = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(e2e) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
