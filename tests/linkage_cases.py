"""Inputs that reach every part of K23's screen and queue
(`csrc/topk_scan.cu`), shared by its emulated and its card tests: a
one-letter alphabet (every pair a tie, the presence words cull nothing),
the source's names (the screen culls most pairs), equal scores across
chunk, queue and tile boundaries, alphabets above 32 chars (presence words
folded mod 32), k = 1 and 8, int32 rows and blocks whose last warp is only
partly full. Also the least count of greedy pairs any correct screen keeps.
Numpy and the port's plain forms only (no jax): the card's machine imports
it too."""
import json
from pathlib import Path

import numpy as np
import torch

from strsim_tpu_torch.ops import topk_cuda
from strsim_tpu_torch.ops.jaro_cuda import jaro_plain
from strsim_tpu_torch.utils import encode as enc

ROOT = Path(__file__).resolve().parents[1]
LETTERS = "abcdefghijklmnopqrstuvwxyz"
WIDE_ASCII = LETTERS + "ABCDEFGHIJ0123456789"  # 46 chars, int8 rows
WIDE_ACCENTED = LETTERS + "éèüöäçñßøåæ"  # 37 chars, int32 rows


def corpus_names() -> list:
    """The benchmark's dictionary: the source's distinct non-empty names."""
    rows = json.loads((ROOT / "perfbench" / "data" / "genealogy_pairs.json").read_text())["rows"]
    return list(dict.fromkeys(x for row in rows for x in row if x))


def _random(rng, n, alphabet, lo, hi):
    return ["".join(rng.choice(list(alphabet), rng.integers(lo, hi + 1))) for _ in range(n)]


def _variants(rng, stems, n, alphabet):
    """n edits (0..2 substitutions) of the stems, in random order."""
    out = []
    for _ in range(n):
        s = list(stems[rng.integers(len(stems))])
        for _ in range(rng.integers(0, 3)):
            s[rng.integers(len(s))] = rng.choice(list(alphabet))
        out.append("".join(s))
    return out


# name -> (k, winkler, tile, threads); the inputs come from `screen_inputs`
SCREEN_CASES = {
    "one_letter": (8, True, 0, 64),
    "corpus": (5, True, 0, 128),
    "corpus_int32_jaro_tiles": (8, False, 300, 96),
    "ties_across_boundaries": (5, True, 20, 32),
    "alphabet_over_32": (1, True, 0, 64),
    "alphabet_over_32_int32": (8, False, 37, 96),
}


def screen_inputs(case: str):
    """(queries, candidates) of a case of SCREEN_CASES."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "one_letter":
        return (["a" * n for n in rng.integers(0, 15, 100)],
                ["a" * n for n in rng.integers(0, 15, 90)])
    if case.startswith("corpus"):
        names = corpus_names()
        qs = [names[i] for i in rng.integers(len(names), size=300)]
        cs = [names[i] for i in rng.permutation(len(names))]
        if case == "corpus_int32_jaro_tiles":
            accent = str.maketrans({"e": "é", "o": "ö"})
            qs, cs = [x.translate(accent) for x in qs], [x.translate(accent) for x in cs]
        return qs, cs
    if case == "ties_across_boundaries":
        # the same few names again and again: equal scores at candidates in
        # different chunks (8), queue fills (32) and tiles (20)
        stems = ["martin", "martina", "marten", "bernard", "bernhard", "anna"]
        return (stems + _variants(rng, stems, 64, "aeinrt"),
                [stems[i % len(stems)] for i in range(150)] + _variants(rng, stems, 30, "aeinrt"))
    if case == "alphabet_over_32":
        return _random(rng, 130, WIDE_ASCII, 1, 20), _random(rng, 120, WIDE_ASCII, 1, 20)
    if case == "alphabet_over_32_int32":
        stems = _random(rng, 12, WIDE_ACCENTED, 4, 14)
        return (_variants(rng, stems, 70, WIDE_ACCENTED) + _random(rng, 60, WIDE_ACCENTED, 0, 20),
                _variants(rng, stems, 60, WIDE_ACCENTED) + _random(rng, 70, WIDE_ACCENTED, 0, 20))
    raise KeyError(case)


def least_greedy_pairs(qs, cs, k: int, winkler: bool = True) -> int:
    """The pairs (both sides non-empty) whose best score by their real m
    (t = 0, the winkler boost taken always, in float64) reaches their query's
    final k-th score: every correct screen keeps them, whatever the order it
    meets the candidates in, since a k-th it screens against is never above
    the final one."""
    q, c = enc.encode_column(qs, pad=enc.PAD_A), enc.encode_column(cs, pad=enc.PAD_B)
    T = torch.from_numpy
    nq, nc = q.n, c.n
    width = max(q.codes.shape[1], c.codes.shape[1], 1)
    a = topk_cuda._pad(T(q.codes).to(torch.int32), width, -1).repeat_interleave(nc, 0)
    b = topk_cuda._pad(T(c.codes).to(torch.int32), width, -2).repeat(nq, 1)
    la = T(q.lengths).to(torch.int32).repeat_interleave(nc)
    lb = T(c.lengths).to(torch.int32).repeat(nq)
    m, _, prefix = jaro_plain(a, b, la, lb, with_prefix=True)
    m, prefix = m.double(), prefix.double()
    x = (m / la.clamp(min=1) + m / lb.clamp(min=1) + 1.0) / 3.0
    if winkler:
        x = x + 0.1 * prefix * (1.0 - x)
    _, best = topk_cuda.topk_plain(T(q.codes), T(q.lengths), T(c.codes), T(c.lengths),
                                   torch.arange(nc), k, winkler)
    kth = best[:, k - 1].repeat_interleave(nc)  # -inf with fewer than k candidates
    return int(((la > 0) & (lb > 0) & (x >= kth)).sum())
