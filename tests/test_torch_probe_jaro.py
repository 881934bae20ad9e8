"""The jaro probes K12-K15 of the port (`strsim_tpu_torch/probes/jaro.py`)
on the CPU.

Their plain versions against the TPU probes they port, run in interpret mode
on the same numpy-seeded inputs, exactly: `tools/ab_jaro_pallas.py` (its
`_scan_kernel` in a `pl.pallas_call` written out here with its specs, since
its wrapper takes no `interpret`), `ab_jaro_wide.py:jaro_wide_pallas`,
`ab_jaro_wide2.py:make_clipped` and `ab_jaro_sol_probe.py:make_variant` in
all four modes, each on its own generator at 512 rows (len-1/len-1 rows
put in where the generator draws lengths from 1). Then the contracts: each
probe's (m, t), patched where the tool patches it, equals K2's plain version
on `chip_smoke.make_tiles` tiles; `transpositions_from_words` equals
`transposition_count`; K13 refuses int32 tiles; the wrappers run their plain
versions on CPU tiles; the bound of ops/roofline.py; and the entry point
`tools/ab_torch_jaro.py` (its CPU smoke, its refusal without a card, and its
imports).
"""
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from strsim_tpu_torch.ops import _build, jaro_cuda, roofline
from strsim_tpu_torch.probes import jaro as probes
from torch_tiles import make_tiles

torch.set_num_threads(1)  # keep torch's pool off the other test workers' cores

ROOT = Path(__file__).resolve().parents[1]
ROWS = 512


@functools.lru_cache(maxsize=None)
def _tool(name):
    """tools/<name>.py, imported by its path (the file is not edited)."""
    spec = importlib.util.spec_from_file_location(f"_tpu_probe_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pad(codes, lens, width):
    """PAD_A / PAD_B past each side's length, as the encoder pads."""
    pos = np.arange(width)[None, :]
    codes[:, :width][pos >= lens[:, :1]] = -1
    codes[:, width:][pos >= lens[:, 1:2]] = -2
    return codes


def _uniform_inputs(width, seed=0):
    """The generator of ab_jaro_pallas.py and ab_jaro_wide.py (make_inputs)
    at ROWS rows: chars 97..122, lengths uniform in 1..width; the first rows
    len-1 against len-1 (equal, then unequal chars)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(97, 123, size=(ROWS, 2 * width), dtype=np.int32)
    lens = rng.integers(1, width + 1, size=(ROWS, 2), dtype=np.int32)
    lens[:4] = 1
    a0 = codes[:4, 0]
    codes[:4, width] = np.where(np.arange(4) % 2 == 0, a0, (a0 - 96) % 26 + 97)
    return _pad(codes, lens, width).astype(np.int8), lens


def _wide2_inputs(width, seed=23):
    """ab_jaro_wide2.py's bucket-realistic lengths (:221-227): the long side
    in [3L/4, L], the short side in 2..L, swapped half the time."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(97, 123, size=(ROWS, 2 * width)).astype(np.int8)
    lens = np.empty((ROWS, 2), np.int32)
    lens[:, 0] = rng.integers((3 * width) // 4, width + 1, size=ROWS)
    lens[:, 1] = rng.integers(2, width + 1, size=ROWS)
    swap = rng.random(ROWS) < 0.5
    lens[swap] = lens[swap][:, ::-1]
    return _pad(codes, lens, width), lens


def _sol_inputs(width, seed=7):
    """ab_jaro_sol_probe.py's inputs (:190-194), lengths in width-7..width,
    padded past the lengths (the probe's eqb_only checksum then sees no
    char beyond a length)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(97, 123, size=(ROWS, 2 * width)).astype(np.int8)
    lens = rng.integers(max(2, width - 7), width + 1, size=(ROWS, 2)).astype(np.int32)
    return _pad(codes, lens, width), lens


def _port_tiles(codes, lens, width, dtype=torch.int8):
    c = torch.from_numpy(codes).to(dtype)
    return (c[:, :width], c[:, width:], torch.from_numpy(lens[:, 0].copy()),
            torch.from_numpy(lens[:, 1].copy()))


def _same(got, want):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_flags_probe(codes, lens, width):
    """ab_jaro_pallas.py's jaro_match_stats_pallas_scan (:100-147) with its
    pallas_call in interpret mode: (raw m, flagged, matched, m, t)."""
    mod = _tool("ab_jaro_pallas")
    i32, u32 = jnp.int32, jnp.uint32
    a, b = jnp.asarray(codes[:, :width]), jnp.asarray(codes[:, width:])
    aT, bT = a.T, b.T
    sub, br8 = mod.SUB, ROWS // mod.SUB

    def pad32(t, pad):
        if width >= mod._WORD:
            return t
        return jnp.concatenate([t, jnp.full((mod._WORD - width, ROWS), pad, dtype=t.dtype)], axis=0)

    a4 = pad32(aT, -1).astype(i32).reshape(mod._WORD, 1, sub, br8).transpose(1, 0, 2, 3)
    b4 = pad32(bT, -2).astype(i32).reshape(mod._WORD, 1, sub, br8).transpose(1, 0, 2, 3)
    la3 = jnp.asarray(lens[:, 0]).reshape(1, sub, br8)
    lb3 = jnp.asarray(lens[:, 1]).reshape(1, sub, br8)
    tile = pl.BlockSpec((1, mod._WORD, sub, br8), lambda g: (g, 0, 0, 0), memory_space=pltpu.VMEM)
    row = pl.BlockSpec((1, sub, br8), lambda g: (g, 0, 0), memory_space=pltpu.VMEM)
    fl, ma, m = pl.pallas_call(
        functools.partial(mod._scan_kernel, L=width),
        out_shape=[jax.ShapeDtypeStruct((1, sub, br8), i32)] * 3,
        grid=(1,), in_specs=[tile, tile, row, row], out_specs=[row, row, row],
        interpret=True,
    )(a4, b4, la3, lb3)
    flagged = lax.bitcast_convert_type(fl.reshape(1, ROWS), u32)
    matched = lax.bitcast_convert_type(ma.reshape(1, ROWS), u32)
    m_raw = m.reshape(ROWS)
    t = mod._transposition_from_masks(aT, bT, matched, flagged)
    one_one = (lens[:, 0] == 1) & (lens[:, 1] == 1)
    m_out = jnp.where(one_one, (aT[0] == bT[0]).astype(i32), m_raw)
    t_out = jnp.where(one_one, 0, t)
    return m_raw, fl.reshape(ROWS), ma.reshape(ROWS), m_out, t_out


# --- the plain versions against the TPU probes, interpreted --------------------

@pytest.mark.parametrize("width", [7, 15, 31])
def test_flags_scan_matches_ab_jaro_pallas(width):
    """K12: raw m and both flag words, then (m, t) after t from the words
    and the len-1/len-1 patch."""
    codes, lens = _uniform_inputs(width)
    m_raw, flagged, matched, m, t = _jax_flags_probe(codes, lens, width)
    tiles = _port_tiles(codes, lens, width)
    got = probes.jaro_flags_scan_plain(*tiles)
    for g, w in zip(got, (m_raw, flagged, matched)):
        _same(g, w)
    for g, w in zip(probes.jaro_flags_probe(*tiles), (m, t)):
        _same(g, w)


@pytest.mark.parametrize("width", [95, 127])
def test_packed_t_matches_ab_jaro_wide(width):
    """K13: (m, t) after the patch, t on byte slots."""
    codes, lens = _uniform_inputs(width)
    fn = _tool("ab_jaro_wide").jaro_wide_pallas
    a, b = jnp.asarray(codes[:, :width]), jnp.asarray(codes[:, width:])
    want = fn(a, b, jnp.asarray(lens[:, 0]), jnp.asarray(lens[:, 1]), block_rows=ROWS,
              interpret=True)
    for g, w in zip(probes.jaro_packed_t_plain(*_port_tiles(codes, lens, width)), want):
        _same(g, w)


@pytest.mark.parametrize("width", [95, 191])
def test_clipped_matches_ab_jaro_wide2(width):
    """K14: raw (m, t) on the bucket-realistic lengths."""
    codes, lens = _wide2_inputs(width)
    want = np.asarray(_tool("ab_jaro_wide2").make_clipped(width, ROWS)(jnp.asarray(codes),
                                                                      jnp.asarray(lens)))
    for clip in probes.CLIPS:
        got = probes.jaro_clipped_plain(*_port_tiles(codes, lens, width), clip=clip)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("mode", probes.MODES)
@pytest.mark.parametrize("width", [15, 31])
def test_ablated_matches_ab_jaro_sol_probe(width, mode):
    """K15: the raw (m, t) of each mode."""
    codes, lens = _sol_inputs(width)
    want = np.asarray(_tool("ab_jaro_sol_probe").make_variant(width, ROWS, mode)(
        jnp.asarray(codes), jnp.asarray(lens)))
    for g, w in zip(probes.jaro_ablated_plain(*_port_tiles(codes, lens, width), mode=mode), want):
        _same(g, w)


# --- contracts -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [7, 31, 95, 383])
def test_each_probe_equals_k2_plain(width, dtype):
    """On `chip_smoke.make_tiles` tiles (lane rows, word-boundary lengths,
    len-1/len-1 rows): each probe's (m, t), patched where the tool patches
    it, equals K2's plain version; K13 only on int8 and K12 only at L <= 32,
    K13 and K14 only above 64."""
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(width * 7 + 1, 300, width, dtype))
    want = jaro_cuda.jaro_plain(a, b, la, lb)

    def patched(m_t):
        return jaro_cuda.patch_one_one(a, b, la, lb, *m_t)

    got = [probes.jaro_ablated(a, b, la, lb, mode="full")]
    if width <= probes.FLAGS_MAX_WIDTH:
        got.append(probes.jaro_flags_probe(a, b, la, lb))
    else:
        got += [probes.jaro_clipped(a, b, la, lb, clip=clip) for clip in probes.CLIPS]
        if dtype == np.int8:
            got.append(probes.jaro_packed_t(a, b, la, lb))
    for pair in got:
        for g, w in zip(patched(pair), want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("width", [7, 32, 95, 511])
def test_transpositions_from_words_equals_transposition_count(width):
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(width + 3, 200, width, np.int8))
    _, matched, flagged = jaro_cuda.greedy_scan(a, b, la, lb)
    words_m, words_f = probes.pack_words(matched), probes.pack_words(flagged)
    assert words_m.shape == (200, -(-width // 32)) and words_m.dtype == torch.int32
    assert torch.equal(probes.unpack_words(words_m, width), matched)
    got = probes.transpositions_from_words(a, b, words_m, words_f)
    assert torch.equal(got, jaro_cuda.transposition_count(a, b, matched, flagged))


def test_packed_t_refuses_int32_tiles():
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(5, 16, 95, np.int32))
    for fn in (probes.jaro_packed_t, probes.packed_t_stats):
        with pytest.raises(TypeError, match="int8"):
            fn(a, b, la, lb)


def test_wrappers_check_their_arguments():
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(6, 16, 63, np.int8))
    with pytest.raises(ValueError, match="outside"):
        probes.jaro_flags_scan(a, b, la, lb)  # K12: L <= 32
    for fn in (probes.jaro_clipped, probes.packed_t_stats):
        with pytest.raises(ValueError, match="outside"):
            fn(a, b, la, lb)  # K13, K14: 65 <= L
    with pytest.raises(ValueError, match="mode"):
        probes.jaro_ablated(a, b, la, lb, mode="t_only")
    with pytest.raises(ValueError, match="clip"):
        probes.jaro_clipped_plain(a, b, la, lb, clip="block")


def test_wrappers_run_their_plain_versions_on_cpu_tiles():
    """CPU tiles take the plain versions; nothing is launched or counted."""
    _build.reset_launch_counts()
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(8, 64, 15, np.int32))
    for g, w in zip(probes.jaro_flags_scan(a, b, la, lb), probes.jaro_flags_scan_plain(a, b, la, lb)):
        assert torch.equal(g, w)
    for mode in probes.MODES:
        for g, w in zip(probes.jaro_ablated(a, b, la, lb, mode=mode),
                        probes.jaro_ablated_plain(a, b, la, lb, mode=mode)):
            assert torch.equal(g, w)
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(9, 64, 95, np.int8))
    for g, w in zip(probes.jaro_packed_t(a, b, la, lb), probes.jaro_packed_t_plain(a, b, la, lb)):
        assert torch.equal(g, w)
    assert _build.launch_counts() == {}


def test_eqb_only_is_the_xor_of_every_equality_word():
    """Hand-worked: a = "ab" + pad, b = "ba", lb = 2: a_0 = 'a' matches b_1
    (bit 1), a_1 = 'b' matches b_0 (bit 0), the pad nothing: 0b11."""
    a = torch.tensor([[97, 98, -1]], dtype=torch.int8)
    b = torch.tensor([[98, 97, -2]], dtype=torch.int8)
    la, lb = torch.tensor([2], dtype=torch.int32), torch.tensor([2], dtype=torch.int32)
    m, t = probes.jaro_ablated_plain(a, b, la, lb, mode="eqb_only")
    assert m.tolist() == [3] and t.tolist() == [3]
    a = torch.tensor([[97, 97, 97]], dtype=torch.int8)  # three a-positions hit b_1: parity 1
    assert probes.equality_xor(a, b, lb).tolist() == [2]


def test_probe_bounds_are_k2s():
    """K12-K15 take K2's bound, K15's eqb_only its own (b's table, then one
    read and one XOR per word of b and a-position); K12 adds its two flag
    words a row."""
    lens = np.array([[40, 7], [33, 9]])
    clock = 1.98e9
    k2 = roofline.bound("jaro_scan", {}, lens, 1, 8, clock)
    for name in ("jaro_packed_t", "jaro_clipped", "jaro_ablated"):
        assert roofline.bound(name, {}, lens, 1, 8, clock) == k2
    for mode in ("full", "no_tcount", "scan_only"):
        assert roofline.bound("jaro_ablated", {"mode": mode}, lens, 1, 8, clock) == k2
    # K2, row by row: table lb + one read and 5 operations per window word
    # and step; (la, lb) = (40, 33): window 19, 40 steps over 2 words;
    # (7, 9): window 3, 7 steps over 1 word
    assert roofline.work_ops("jaro_scan", {}, lens[0], lens[1]) == (33 + 6 * 2 * 40) + (9 + 6 * 1 * 7)
    # eqb_only: lb + 2 x words of b x la = (33 + 2 * 2 * 40) + (9 + 2 * 1 * 7)
    ops = roofline.work_ops("jaro_ablated", {"mode": "eqb_only"}, lens[0], lens[1])
    assert ops == 216
    ms, by = roofline.bound("jaro_ablated", {"mode": "eqb_only"}, lens, 1, 8, clock)
    assert (ms, by) == (max(216 / (roofline.INT32_LANES * clock),
                            (40 + 33 + 8 + 8 + 7 + 9 + 8 + 8) / roofline.HBM_BYTES_PER_S) * 1e3,
                        "bytes")
    assert roofline.work_ops("jaro_flags_probe", {}, lens[0], lens[1]) == roofline.work_ops(
        "jaro_scan", {}, lens[0], lens[1])
    ms, by = roofline.bound("jaro_flags_probe", {}, lens, 1, 12, clock)
    assert ms >= k2[0]


# --- the entry point -------------------------------------------------------------

def _tool_run(*args):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "tools/ab_torch_jaro.py", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_tool_cpu_smoke(tmp_path):
    out = tmp_path / "ab.json"
    res = _tool_run("--device", "cpu", "--out", str(out))
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["parity"] == "exact" and line["cases"] == 6
    assert set(line["k2_over_arm"].values()) == {"not measured"}
    d = json.loads(out.read_text())
    assert {c["probe"] for c in d["cases"]} == {"pallas", "wide", "wide2", "sol"}
    for case in d["cases"]:
        assert case["parity"] == "exact" and case["k2"]["ms"] == "not measured"
        assert all(arm == {"ms": "not measured"} for arm in case["arms"].values())
    assert set(d["cases"][-1]["arms"]) == set(probes.MODES)


def test_tool_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _tool_run("--probes", "sol")
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_probes_and_tool_import_neither_jax_nor_strsim_tpu(tmp_path):
    code = (
        "import sys, runpy\n"
        "import strsim_tpu_torch.probes.jaro\n"
        f"sys.argv = ['ab_torch_jaro.py', '--device', 'cpu', '--probes', 'sol', '--out', {str(tmp_path / 'x.json')!r}]\n"
        "try:\n"
        "    runpy.run_path('tools/ab_torch_jaro.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'strsim_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "clean"
    sources = [ROOT / "strsim_tpu_torch" / "csrc" / "probe_jaro.cu", ROOT / "tools" / "ab_torch_jaro.py",
               ROOT / "chip_smoke.py", *sorted((ROOT / "strsim_tpu_torch" / "probes").glob("*.py"))]
    for path in sources:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "import strsim_tpu\n" not in text and "from strsim_tpu " not in text, path
        assert "from strsim_tpu." not in text and "import strsim_tpu." not in text, path
