"""strsim_tpu_torch's native host layer (strsim_tpu_torch/native/) against
strsim_tpu's native library and the oracle, on the same seeded rows: the
scalar kernels of all fourteen measures (one thread and every core), the
finalize and scatter, the bucket pack in the port's [2, n] lengths layout,
row equality and the phonetic keys; and its build, which two processes can
run at once and which raises when the compiler fails."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from strsim_tpu.native import binding as jnb
from strsim_tpu.utils import encode as jenc
from strsim_tpu_torch.native import binding as tnb
from strsim_tpu_torch.native import build as tbuild
from strsim_tpu_torch.ops import finalize as tfinalize
from strsim_tpu_torch.ops.oracle import ORACLES
from strsim_tpu_torch.utils import encode as tenc

# a single intra-op thread: these tests are numpy/ctypes work, and torch's
# spinning pool would compete with the other test workers for the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MEASURES = tuple(tnb.MEASURE_IDS)
ALPHABETS = ["abcab", "ab\0 z", "éЖ你￿a", "😀\U0010ffffab"]


def mixed_rows(seed: int, n: int):
    """Two columns of str|None: ASCII, BMP and astral chars, NUL (also
    trailing), empty and null rows, equal pairs and near-duplicates; most
    rows short, a few 100..600 chars (widths 1..600)."""
    rng = np.random.default_rng(seed)
    col_a, col_b = [], []
    for i in range(n):
        alphabet = ALPHABETS[i % len(ALPHABETS)]
        la = int(rng.integers(100, 601)) if i % 23 == 7 else int(rng.integers(0, 31))
        a = "".join(rng.choice(list(alphabet), la))
        if i % 5 == 0:
            b = a
        elif i % 5 == 1 and a:
            p = int(rng.integers(0, len(a)))
            b = a[:p] + "x" + a[p + 1:]
        else:
            b = "".join(rng.choice(list(alphabet), int(rng.integers(0, max(la, 1) + 3))))
        if i % 11 == 3:
            a += "\0"
        col_a.append(None if i % 17 == 5 else a)
        col_b.append(None if i % 19 == 6 else b)
    return col_a, col_b


@pytest.fixture(scope="module")
def rows():
    col_a, col_b = mixed_rows(0, 140)
    a, b = tenc.encode_pair(col_a, col_b)
    return col_a, col_b, a, b


@pytest.mark.parametrize("measure", MEASURES)
def test_native_compute_matches_jax_and_oracle(rows, measure):
    """One thread and every core, byte-identical in f64 to strsim_tpu's
    native library and to the oracle; NaN at null rows."""
    col_a, col_b, a, b = rows
    validity = a.validity & b.validity
    want = np.array([np.nan if x is None or y is None else ORACLES[measure](x, y)
                     for x, y in zip(col_a, col_b)])
    jax_scores = jnb.native_compute(measure, a.codes, a.lengths, b.codes, b.lengths, validity)
    for threads in (1, 0):
        got = tnb.native_compute(measure, a.codes, a.lengths, b.codes, b.lengths, validity,
                                 threads=threads)
        assert got.tobytes() == want.tobytes(), (measure, threads)
        assert got.tobytes() == jax_scores.tobytes(), (measure, threads)


def random_stats(rng, la, lb, fields):
    """Integer stats in their fields' ranges for rows of lengths la, lb."""
    short = np.minimum(la, lb)
    stats = {}
    for f in fields:
        if f == "jaro_t":
            stats[f] = rng.integers(0, 2 * short + 1)
        elif f == "prefix":
            stats[f] = rng.integers(0, np.minimum(short, 4) + 1)
        elif f in ("eq", "sdx_eq"):
            stats[f] = rng.integers(0, 2, la.size)
        elif f in ("lev_d", "osa_d"):
            stats[f] = rng.integers(0, np.maximum(la, lb) + 1)
        else:
            stats[f] = rng.integers(0, short + 1)
    return {f: v.astype(np.int32) for f, v in stats.items()}


@pytest.mark.parametrize("measure", MEASURES)
def test_finalize_scatter_matches_numpy_and_jax(measure):
    """The threaded finalize and scatter, byte-identical to the port's numpy
    finalizers and to strsim_tpu's native finalize, with and without scatter
    indices, over more rows than one thread takes (65,536)."""
    rng = np.random.default_rng(MEASURES.index(measure))
    n = 70_000
    la = rng.integers(0, 40, n).astype(np.int32)
    lb = rng.integers(0, 40, n).astype(np.int32)
    la[:50] = lb[:50] = 0
    lb[50:100] = 0
    stats = random_stats(rng, la, lb, tnb.FINALIZE_FIELDS[measure])
    want = tfinalize.FINALIZERS[measure]({f: v.astype(np.int64) for f, v in stats.items()},
                                         la.astype(np.int64), lb.astype(np.int64))
    got = np.full(n, -5.0)
    tnb.finalize_scatter(measure, stats, la, lb, got)
    assert got.tobytes() == want.tobytes()
    sel = rng.permutation(n + 10)[:n]
    scattered, theirs = np.full(n + 10, -5.0), np.full(n + 10, -5.0)
    tnb.finalize_scatter(measure, stats, la, lb, scattered, sel)
    assert jnb.finalize_scatter(measure, stats, la, lb, theirs, sel)
    assert scattered[sel].tobytes() == want.tobytes()
    assert scattered.tobytes() == theirs.tobytes()


def test_finalize_scatter_refuses_what_it_cannot_take():
    la = lb = np.ones(4, np.int32)
    stats = {"lev_d": np.zeros(4, np.int32)}
    with pytest.raises(ValueError, match="float64"):
        tnb.finalize_scatter("levenshtein", stats, la, lb, np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="float64"):
        tnb.finalize_scatter("levenshtein", stats, la, lb, np.zeros((4, 2))[:, 0])
    with pytest.raises(ValueError, match="past"):
        tnb.finalize_scatter("levenshtein", stats, la, lb, np.zeros(4), np.array([0, 1, 2, 4]))
    with pytest.raises(KeyError):
        tnb.finalize_scatter("levenshtein", {"inter": stats["lev_d"]}, la, lb, np.zeros(4))


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_pack_bucket_matches_numpy_in_the_ports_layout(dtype):
    """pack_bucket gathers the selected rows a | b into [n_out, 2 * width]
    and their lengths into [2, n_out] (a's, then b's), pad rows after them,
    as the numpy pack does; over more rows than one thread takes, with
    la != lb on every block and source tiles narrower and wider than the
    bucket."""
    rng = np.random.default_rng(int(np.dtype(dtype).itemsize))
    n_src = 90_000
    for w_src, width in ((20, 31), (47, 31), (31, 31)):
        top = 128 if dtype == np.int8 else 0x110000
        la = rng.integers(0, min(w_src, width) + 1, n_src).astype(np.int32)
        lb = rng.integers(0, min(w_src, width) + 1, n_src).astype(np.int32)
        codes_a = rng.integers(0, top, (n_src, w_src)).astype(dtype)
        codes_b = rng.integers(0, top, (n_src, w_src)).astype(dtype)
        pos = np.arange(w_src)[None, :]
        codes_a[pos >= la[:, None]] = -1
        codes_b[pos >= lb[:, None]] = -2
        sel = rng.permutation(n_src)[:70_000]
        n_out = 71_000
        packed = np.empty((n_out, 2 * width), dtype)
        lens = np.empty((2, n_out), np.int32)
        tnb.pack_bucket(codes_a, codes_b, la, lb, sel, width, -1, -2, packed, lens)
        want = np.concatenate([np.full((n_out, width), -1, dtype), np.full((n_out, width), -2, dtype)], 1)
        k = min(w_src, width)
        want[: sel.size, :k] = codes_a[sel, :k]
        want[: sel.size, width: width + k] = codes_b[sel, :k]
        want_lens = np.zeros((2, n_out), np.int32)
        want_lens[0, : sel.size], want_lens[1, : sel.size] = la[sel], lb[sel]
        assert np.array_equal(packed, want), (w_src, width)
        assert np.array_equal(lens, want_lens), (w_src, width)
    with pytest.raises(ValueError, match="lens"):
        tnb.pack_bucket(codes_a, codes_b, la, lb, sel, width, -1, -2, packed,
                        np.empty((n_out, 2), np.int32))


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_equal_rows_native_matches_numpy(dtype):
    rng = np.random.default_rng(7)
    n, w = 80_000, 9
    la = rng.integers(0, w + 1, n).astype(np.int32)
    lb = np.where(rng.random(n) < 0.5, la, rng.integers(0, w + 1, n)).astype(np.int32)
    codes_a = rng.integers(0, 3, (n, w)).astype(dtype)
    codes_b = np.where(rng.random((n, w)) < 0.9, codes_a, rng.integers(0, 3, (n, w))).astype(dtype)
    pos = np.arange(w)[None, :]
    codes_a[pos >= la[:, None]] = -1
    codes_b[pos >= lb[:, None]] = -2
    a = tenc.EncodedColumn(codes_a, la, np.ones(n, bool))
    b = tenc.EncodedColumn(codes_b, lb, np.ones(n, bool))
    got = tnb.equal_rows_native(codes_a, codes_b, la, lb)
    assert got.dtype == bool and got.any() and not got.all()
    assert np.array_equal(got, tenc.equal_rows_numpy(a, b))
    assert np.array_equal(tenc.equal_rows(a, b), got)


@pytest.mark.parametrize("method", ["soundex", "nysiis"])
def test_phonetic_codes_match_jax(method):
    col = ["Robert", "Rupert", "", None, "Ashcraft", "Tymczak", "Pfister", "MacDonald",
           "Knight", "Schmidt", "123", "éa", "Lloyd"] * 400
    got = tnb.native_phonetic_codes(col, method)
    want = jnb.native_phonetic_codes(col, method)
    assert list(got) == list(want)
    assert list(tnb.native_phonetic_codes(tenc.encode_column(col), method, threads=1)) == list(want)
    with pytest.raises(KeyError, match="unknown phonetic"):
        tnb.native_phonetic_codes(col, "metaphone")


def test_decode_utf8_column_matches_jax():
    col = ["abc", "", "héllo", "😀x", "\0a\0"]
    data = "".join(col).encode("utf-8")
    offsets = np.cumsum([0] + [len(s.encode("utf-8")) for s in col]).astype(np.int64)
    validity = np.array([1, 1, 0, 1, 1], np.uint8)
    buf = np.frombuffer(data, np.uint8)
    got = tnb.decode_utf8_column(buf, offsets, validity, 8, tenc.PAD_B)
    want = jnb.decode_utf8_column(buf, offsets, validity, 8, jenc.PAD_B)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="longer than tile width"):
        tnb.decode_utf8_column(buf, offsets, None, 2, tenc.PAD_A)


def test_two_processes_build_into_one_empty_directory(tmp_path):
    """Two processes that build the library at once into an empty directory
    both load it: each compiles into a name of its own and renames."""
    code = ("from strsim_tpu_torch.native import build; "
            "lib = build.get_lib(); print(build.target().name, build.has_object_routes())")
    env = {**os.environ, "STRSIM_TPU_TORCH_BUILD_DIR": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and outs[0][0].split()[1] == "True"
    assert [f.name for f in tmp_path.iterdir()] == [outs[0][0].split()[0]]


def test_a_failed_build_raises(tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" int f() { return missing_symbol; }\n')
    with pytest.raises(RuntimeError, match="missing_symbol"):
        tbuild.build_library(broken, tmp_path)
    assert not any(tmp_path.glob("*.so"))


def test_build_names_carry_source_flags_and_machine(tmp_path):
    other = tmp_path / "other.cpp"
    other.write_text(tbuild.SRC.read_text() + "\n// edited\n")
    assert tbuild.target().parent == tbuild.target(tbuild.SRC, None).parent
    assert tbuild.target(other, tmp_path).name != tbuild.target(tbuild.SRC, tmp_path).name
    assert "-ffp-contract=off" in tbuild.flags() and "-march=native" in tbuild.flags()
