"""The plain reference: the five measures against the read-only golden cases
of the reference's test corpus, the nine extensions against cases worked by
hand from their definitions, the row conventions, and its imports."""
import importlib
import json
import math
import re
import subprocess
import sys

import numpy as np
import pytest

from _paths import ROOT
from perfbench.reference import _rows

FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
EXTENSIONS = ("jaccard_bigram", "sorensen_dice_bigram", "cosine", "overlap", "hamming",
              "lcs_seq", "indel", "osa", "soundex")


def scores(measure, a, b, dtype=np.float64):
    return importlib.import_module(f"perfbench.reference.{measure}").scores(a, b, dtype)


@pytest.mark.parametrize("measure", FIVE)
def test_five_match_the_golden_cases(measure):
    # the corpus gives 8 decimals: the reference's own tolerance, 1e-8 (strsim.rs:350)
    cases = json.loads((ROOT / "tests" / "golden" / f"{measure}.json").read_text())
    got = scores(measure, [c[0] for c in cases], [c[1] for c in cases])
    want = np.array([c[2] for c in cases])
    assert np.all(np.abs(got - want) < 1e-8), [c for c, g in zip(cases, got) if abs(g - c[2]) >= 1e-8][:3]


# (measure, a, b, score worked by hand from the definition)
HAND = [
    ("jaccard_bigram", "night", "nacht", 1 / 7),          # ni ig gh ht / na ac ch ht: 1 shared
    ("jaccard_bigram", "aaa", "aa", 1 / (2 + 1 - 1)),     # {aa, aa} and {aa}
    ("jaccard_bigram", "a", "b", 0.0),                    # no bigram on a side
    ("sorensen_dice_bigram", "night", "nacht", 2 * 1 / 8),
    ("sorensen_dice_bigram", "abcd", "bcde", 2 * 2 / 6),  # bc, cd shared
    ("sorensen_dice_bigram", "x", "xy", 0.0),
    ("cosine", "abc", "abd", 2 / math.sqrt(9)),
    ("cosine", "aab", "ab", 2 / math.sqrt(6)),
    ("overlap", "abc", "abcd", 3 / 3),
    ("overlap", "ab", "bc", 1 / 2),
    ("hamming", "karolin", "kathrin", 4 / 7),             # k a . . . i n
    ("hamming", "abc", "ab", 2 / 3),                      # the length gap mismatches
    ("lcs_seq", "ABCBDAB", "BDCABA", 4 / 7),              # BCBA
    ("indel", "ABCBDAB", "BDCABA", 2 * 4 / 13),
    ("osa", "ca", "abc", 1 - 3 / 3),                      # no substring edited twice
    ("osa", "ab", "ba", 1 - 1 / 2),
    ("osa", "abcd", "acbd", 1 - 1 / 4),
    ("soundex", "Robert", "Rupert", 1.0),                 # R163
    ("soundex", "Ashcraft", "Ashcroft", 1.0),             # A261: h does not separate s and c
    ("soundex", "Robert", "Rubin", 0.0),                  # R163 against R150
    ("soundex", "Tymczak", "Tymczuk", 1.0),               # T522
    ("soundex", "123", "4-5", 1.0),                       # no letter: both the empty code
]


@pytest.mark.parametrize("measure,a,b,want", HAND)
def test_extensions_match_cases_worked_by_hand(measure, a, b, want):
    assert scores(measure, [a], [b])[0] == want


@pytest.mark.parametrize("measure", FIVE + EXTENSIONS)
def test_row_conventions(measure):
    got = scores(measure, [None, "a", None, "", "", "abc", "x", "same"],
                 ["a", None, None, "", "abc", "", "x", "same"])
    assert np.isnan(got[:3]).all()
    assert list(got[3:]) == [1.0, 0.0, 0.0, 1.0, 1.0]


def test_soundex_codes():
    assert [_rows.soundex_code(s) for s in ("Robert", "Rupert", "Rubin", "Ashcraft", "Tymczak",
                                            "Pfister", "Lee", "", "12")] == \
        ["R163", "R163", "R150", "A261", "T522", "P236", "L000", "", ""]


def test_float32_differs_from_float64():
    a, b = ["martha", "dixon", "jellyfish"], ["marhta", "dicksonx", "smellyfish"]
    for m in FIVE:
        assert not np.array_equal(scores(m, a, b, np.float32), scores(m, a, b)), m


def test_reference_imports_nothing_of_the_program():
    names = ["_rows"] + list(FIVE + EXTENSIONS)
    code = ("import sys; sys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import perfbench.reference.{n}\n" for n in names)
            + "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    loaded = set(eval(out.stdout))
    assert not loaded & {"strsim_tpu_torch", "strsim_tpu", "jax", "jaxlib", "torch", "bench"}
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        assert not re.search(r"^\s*(from|import)\s+(strsim_tpu|bench|torch)", path.read_text(), re.M), path
