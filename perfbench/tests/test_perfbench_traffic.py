"""The source's rows reach the columns as the configuration states: the data
file holds the distinct rows of the reference's test corpus and README
example, every seed makes the same rows in its own order, and the general
generator's inputs follow from the seed alone."""
import collections
import json

import numpy as np
import pytest

from _paths import ROOT
from perfbench import loadgen
from perfbench.generators import source_rows

FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
README_A = ["phillips", "phillips", "", "", None, None]  # README.md:35-72, demo.py
README_B = ["phillips", "philips", "phillips", "", "phillips", None]


def _params():
    return loadgen.read_json(loadgen.HERE / "configs" / "genealogy_names.json")["params"]


def _rows():
    return [tuple(r) for r in loadgen.read_json(loadgen.HERE / _params()["rows"])["rows"]]


def test_data_file_is_the_sources_rows():
    want = []
    for m in FIVE:
        for a, b, _ in json.loads((ROOT / "tests" / "golden" / f"{m}.json").read_text()):
            want.append((a, b))
    want += list(zip(README_A, README_B))
    assert _rows() == list(dict.fromkeys(want))  # each distinct row once, first appearance
    assert len(_rows()) == 582


@pytest.mark.parametrize("n", [582 * 3, 582 * 5 + 17])
def test_every_seed_makes_the_same_rows(n):
    rows = _rows()
    cols = [source_rows.generate(n, seed, **_params()) for seed in (7, 2**31 + 11, 2**62 + 5)]
    counts = [collections.Counter(zip(a, b)) for a, b in cols]
    assert counts[0] == counts[1] == counts[2]
    assert set(counts[0].values()) <= {n // len(rows), n // len(rows) + 1}
    assert list(cols[0][1]) != list(cols[1][1])  # the seed draws the order


def test_each_row_is_a_str_of_its_own():
    a, b = source_rows.generate(582 * 4, 3, **_params())
    long_a = [s for s in a if s is not None and len(s) > 1]
    assert len({id(s) for s in long_a}) == len(long_a)  # as to_list() hands them over
    assert all(isinstance(s, str) or s is None for s in list(a) + list(b))


def test_rows_decided_on_the_host():
    rows = _rows()
    null = sum(a is None or b is None for a, b in rows)
    equal = sum(a is not None and a == b for a, b in rows)
    one_empty = sum(a is not None and b is not None and a != b and not (a and b) for a, b in rows)
    assert (null, equal, one_empty) == (2, 3, 5)
    lens = [len(s) for r in rows for s in r if s is not None]
    assert max(lens) == 27 and all(s.isascii() for r in rows for s in r if s is not None)


def _load(cell, seed, scale):
    return loadgen.load(loadgen.manifest(), cell, seed, scale)


def test_inputs_follow_the_seed():
    w1 = _load("names.five.1m", 123, 0.002)
    w2 = _load("names.five.1m", 123, 0.002)
    w3 = _load("names.five.1m", 124, 0.002)
    assert [i.a for i in w1.inputs] == [i.a for i in w2.inputs]
    assert [i.b for i in w1.inputs] == [i.b for i in w2.inputs]
    assert [i.b for i in w1.inputs] != [i.b for i in w3.inputs]
    assert len(w1.inputs) == 2 and w1.inputs[0].b != w1.inputs[1].b
    assert w1.inputs[0].rows == 2000
    assert np.array_equal(w1.inputs[0].device_rows()[0], w2.inputs[0].device_rows()[0])
