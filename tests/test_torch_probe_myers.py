"""The Myers and fused lev + jaro probes K16-K19 of the port
(`strsim_tpu_torch/probes/myers.py`) on the CPU.

Their plain versions against the TPU probes they port, run in interpret mode
on the same numpy-seeded inputs, exactly: `tools/ab_myers_pallas.py`'s
`_scan_kernel` (both `unroll` values) and `_ineq_kernel`, and
`ab_myers_swar.py`'s `_kernel_swar`, each in a `pl.pallas_call` written out
here at a 512-row block (the tools' wrappers take no `interpret`, or assert
8192-row blocks), and `ab_fused_lj.py:make_fused` at L = 15 and 31, each on
its tool's generator at 512 rows with len-0 and len-1 rows put in. Then the
contracts: on `chip_smoke.make_tiles` tiles K16-K18 equal K1's plain version
where both lengths are >= 1, and K19 equals K5's plain version (lev) and
K2's (m, t after the len-1/len-1 patch); `pattern_eq_words` equals the
tool's XLA build; K18 and K19 refuse int32 tiles; the wrappers run their
plain versions on CPU tensors; K16's bound of ops/roofline.py; and the entry
point `tools/ab_torch_myers.py` (its CPU smoke, its refusal without a card,
and its imports).
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

from strsim_tpu_torch.ops import _build, jaro_cuda, lev_jaro_cuda, levenshtein_cuda, roofline
from strsim_tpu_torch.probes import myers as probes
from torch_tiles import make_tiles

torch.set_num_threads(1)  # keep torch's pool off the other test workers' cores

ROOT = Path(__file__).resolve().parents[1]
ROWS = 512
SUB = 8


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


def _edge_rows(lens):
    """len-0 and len-1 rows over the first 16: la = 0 against lb 0..3,
    then len-1 against len-1, 2 and 0, and the other way round."""
    lens[:4, 0], lens[:4, 1] = 0, np.arange(4)
    lens[4:10, 0], lens[4:10, 1] = 1, [1, 1, 1, 2, 0, 3]
    lens[10:16, 0], lens[10:16, 1] = [2, 0, 3, 1, 1, 1], 1


def _myers_inputs(width, seed=0):
    """ab_myers_pallas.py / ab_myers_swar.py make_inputs at ROWS rows:
    chars 97..122, lengths uniform in 1..width, int8; the edge rows, the
    equal chars of the first len-1/len-1 rows, then the pads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(97, 123, size=(ROWS, 2 * width), dtype=np.int32)
    lens = rng.integers(1, width + 1, size=(ROWS, 2), dtype=np.int32)
    _edge_rows(lens)
    codes[4:6, width] = codes[4:6, 0]
    return _pad(codes, lens, width).astype(np.int8), lens


def _fused_inputs(width, seed=11):
    """ab_fused_lj.py:main's generator at ROWS rows: lengths in 2..L, the
    first ROWS / 8 in 2..4; the edge rows, then the pads (the tool leaves
    its codes unpadded; the encoder pads)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(97, 123, size=(ROWS, 2 * width)).astype(np.int8)
    lens = rng.integers(2, width + 1, size=(ROWS, 2)).astype(np.int32)
    lens[: ROWS // 8] = rng.integers(2, 5, size=(ROWS // 8, 2))
    _edge_rows(lens)
    codes[4:6, width] = codes[4:6, 0]
    return _pad(codes, lens, width), lens


def _port_tiles(codes, lens, width, dtype=torch.int8):
    c = torch.from_numpy(codes).to(dtype)
    return (c[:, :width], c[:, width:], torch.from_numpy(lens[:, 0].copy()),
            torch.from_numpy(lens[:, 1].copy()))


def _same(got, want):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1))


def _specs(rows):
    br8 = ROWS // SUB
    tile = pl.BlockSpec((1, rows, SUB, br8), lambda g: (g, 0, 0, 0), memory_space=pltpu.VMEM)
    row = pl.BlockSpec((1, SUB, br8), lambda g: (g, 0, 0), memory_space=pltpu.VMEM)
    return tile, row


def _fold(x):
    """[rows, B] -> [1, rows, 8, B / 8], the tools' block layout."""
    return x.reshape(x.shape[0], 1, SUB, ROWS // SUB).transpose(1, 0, 2, 3)


def _lens3(lens):
    return (jnp.asarray(lens[:, 0]).reshape(1, SUB, ROWS // SUB),
            jnp.asarray(lens[:, 1]).reshape(1, SUB, ROWS // SUB))


def _xla_eq(codes, width):
    """tools/ab_myers_pallas.py's XLA build of the Eq words (:184-195),
    [L, B] int32."""
    mod = _tool("ab_myers_pallas")
    aT = jnp.asarray(codes[:, :width]).T
    bT = jnp.asarray(codes[:, width:]).T
    aTp = mod._pad_rows(aT, ROWS, mod._WORD)
    bits = np.uint32(1) << jnp.arange(mod._WORD, dtype=jnp.uint32)
    eq4 = aTp.reshape(1, mod._WORD, ROWS) == bT[:, None, :]
    eq = jnp.sum(jnp.where(eq4, bits[None, :, None], np.uint32(0)), axis=1, dtype=jnp.uint32)
    return lax.bitcast_convert_type(eq, jnp.int32)


def _jax_scan(codes, lens, width, unroll):
    """`_scan_kernel` over the XLA-built words, interpreted."""
    mod = _tool("ab_myers_pallas")
    tile, row = _specs(width)
    out = pl.pallas_call(
        functools.partial(mod._scan_kernel, L=width, unroll=unroll),
        out_shape=jax.ShapeDtypeStruct((1, SUB, ROWS // SUB), jnp.int32),
        grid=(1,), in_specs=[tile, row, row], out_specs=row, interpret=True,
    )(_fold(_xla_eq(codes, width)), *_lens3(lens))
    return out.reshape(ROWS)


def _jax_ineq(codes, lens, width):
    """`_ineq_kernel` on i32 char tiles, a padded with PAD_A to 32 rows."""
    mod = _tool("ab_myers_pallas")
    aT = jnp.asarray(codes[:, :width]).T
    bT = jnp.asarray(codes[:, width:]).T
    a4 = _fold(mod._pad_rows(aT, ROWS, mod._WORD).astype(jnp.int32))
    b4 = _fold(bT.astype(jnp.int32))
    tile_a, row = _specs(mod._WORD)
    tile_b, _ = _specs(width)
    out = pl.pallas_call(
        functools.partial(mod._ineq_kernel, L=width),
        out_shape=jax.ShapeDtypeStruct((1, SUB, ROWS // SUB), jnp.int32),
        grid=(1,), in_specs=[tile_a, tile_b, row, row], out_specs=row, interpret=True,
    )(a4, b4, *_lens3(lens))
    return out.reshape(ROWS)


def _jax_swar(codes, lens, width):
    """`_kernel_swar` as ab_myers_swar.py:lev_swar calls it, at ROWS rows a
    block."""
    mod = _tool("ab_myers_swar")
    a4 = _fold(jnp.asarray(codes[:, :width]).T.astype(jnp.int32))
    b4 = _fold(jnp.asarray(codes[:, width:]).T.astype(jnp.int32))
    tile, row = _specs(width)
    out = pl.pallas_call(
        functools.partial(mod._kernel_swar, L=width),
        out_shape=jax.ShapeDtypeStruct((1, SUB, ROWS // SUB), jnp.int32),
        grid=(1,), in_specs=[tile, tile, row, row], out_specs=row, interpret=True,
    )(a4, b4, *_lens3(lens))
    return out.reshape(ROWS)


# --- the plain versions against the TPU probes, interpreted --------------------

@pytest.mark.parametrize("unroll", [False, True], ids=["scan", "unroll"])
@pytest.mark.parametrize("width", [7, 15, 31, 32])
def test_eq_scan_matches_ab_myers_pallas_scan_kernel(width, unroll):
    """K16 over the tool's XLA-built words."""
    codes, lens = _myers_inputs(width)
    want = _jax_scan(codes, lens, width, unroll)
    eq = torch.from_numpy(np.array(_xla_eq(codes, width)))
    _, _, la, lb = _port_tiles(codes, lens, width)
    _same(probes.myers_eq_scan_plain(eq, la, lb, unroll), want)


@pytest.mark.parametrize("width", [7, 15, 31, 32])
def test_pattern_eq_words_match_the_tools_xla_build(width):
    codes, lens = _myers_inputs(width)
    for dtype in (torch.int8, torch.int32):
        a, b, _, _ = _port_tiles(codes, lens, width, dtype)
        got = probes.pattern_eq_words(a, b)
        assert got.shape == (width, ROWS) and got.is_contiguous()
        _same(got.reshape(-1), np.asarray(_xla_eq(codes, width)).reshape(-1))


@pytest.mark.parametrize("width", [7, 15, 31, 32])
def test_ineq_matches_ab_myers_pallas_ineq_kernel(width):
    """K17 on int8 and int32 tiles of the same codes."""
    codes, lens = _myers_inputs(width)
    want = _jax_ineq(codes, lens, width)
    for dtype in (torch.int8, torch.int32):
        _same(probes.myers_ineq_plain(*_port_tiles(codes, lens, width, dtype)), want)


@pytest.mark.parametrize("width", [7, 15, 31])
def test_swar_matches_ab_myers_swar(width):
    """K18 on int8 tiles."""
    codes, lens = _myers_inputs(width)
    _same(probes.myers_swar_plain(*_port_tiles(codes, lens, width)), _jax_swar(codes, lens, width))


@pytest.mark.parametrize("width", [15, 31])
def test_fused_matches_ab_fused_lj(width):
    """K19's raw (lev, m, t) on the tool's generator."""
    codes, lens = _fused_inputs(width)
    want = np.asarray(_tool("ab_fused_lj").make_fused(width, ROWS)(jnp.asarray(codes),
                                                                  jnp.asarray(lens)))
    for g, w in zip(probes.fused_lev_jaro_plain(*_port_tiles(codes, lens, width)), want):
        _same(g, w)


# --- contracts -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [7, 15, 31, 32])
def test_myers_probes_equal_k1_plain(width, dtype):
    """On `chip_smoke.make_tiles` tiles (lane rows, word-boundary lengths,
    len-0 and len-1 rows): K16 (both loops), K17 and, on int8, K18 equal
    K1's plain version on every row whose lengths are both >= 1."""
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(width * 5 + 2, 300, width, dtype))
    both = (la >= 1) & (lb >= 1)
    assert 0 < int(both.sum()) < 300
    want = levenshtein_cuda.myers_plain(a, b, la, lb)[both]
    got = [probes.myers_eq_arm(a, b, la, lb, unroll) for unroll in (False, True)]
    got.append(probes.myers_ineq(a, b, la, lb))
    if dtype == np.int8:
        got.append(probes.myers_swar(a, b, la, lb))
    for g in got:
        assert torch.equal(g[both], want)


@pytest.mark.parametrize("width", [7, 15, 31])
def test_fused_equals_k5_and_k2_plain(width):
    """K19's lev equals K5's plain lev (K1's recurrence) on every row, and
    its (m, t) after the len-1/len-1 patch K2's plain (m, t)."""
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(width * 3 + 1, 300, width, np.int8))
    lev, m, t = probes.fused_lev_jaro(a, b, la, lb)
    want = lev_jaro_cuda.lev_jaro_plain(a, b, la, lb)
    assert torch.equal(lev, want[0])
    for g, w in zip(jaro_cuda.patch_one_one(a, b, la, lb, m, t), jaro_cuda.jaro_plain(a, b, la, lb)):
        assert torch.equal(g, w)
    for g, w in zip(jaro_cuda.patch_one_one(a, b, la, lb, m, t), want[1:3]):
        assert torch.equal(g, w)


def test_swar_words_equal_the_compares_inside_the_pattern():
    """Every int8 byte, the sign bit's included: the exact zero-byte test
    and the nibble gather give (a_i == b_j) at every i < L, and at L = 31
    the fill byte 0xFF the compare with PAD_A at i = 31."""
    codes = np.arange(-128, 128, dtype=np.int64)
    a = torch.from_numpy(np.stack([np.roll(codes, k)[:31] for k in range(256)]).astype(np.int8))
    b = torch.from_numpy(np.stack([np.roll(codes, 3 * k)[:31] for k in range(256)]).astype(np.int8))
    b[:, ::2] = a[:, ::2]
    words = probes.swar_eq_words(a, b)
    assert int((b == -1).sum()) > 0
    assert torch.equal(words, probes.pattern_eq_words(a, b).long() & probes.MASK)


def test_int8_only_probes_refuse_int32_tiles():
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(5, 16, 15, np.int32))
    for fn in (probes.myers_swar, probes.myers_swar_plain, probes.fused_lev_jaro,
               probes.fused_lev_jaro_plain):
        with pytest.raises(TypeError, match="int8"):
            fn(a, b, la, lb)


def test_wrappers_check_their_arguments():
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(6, 16, 33, np.int8))
    for fn in (probes.myers_ineq, probes.myers_swar, probes.fused_lev_jaro, probes.pattern_eq_words):
        with pytest.raises(ValueError, match="outside"):
            fn(*((a, b, la, lb) if fn is not probes.pattern_eq_words else (a, b)))
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(6, 16, 32, np.int8))
    with pytest.raises(ValueError, match="outside"):
        probes.fused_lev_jaro(a, b, la, lb)  # K19: L <= 31
    eq = probes.pattern_eq_words(a, b)
    with pytest.raises(ValueError, match="contiguous int32"):
        probes.myers_eq_scan(eq.t(), la, lb)
    with pytest.raises(ValueError, match="len_b"):
        probes.myers_eq_scan(eq, la, lb[:8])


def test_wrappers_run_their_plain_versions_on_cpu_tiles():
    """CPU tensors take the plain versions; nothing is launched or counted."""
    _build.reset_launch_counts()
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(8, 64, 15, np.int8))
    eq = probes.pattern_eq_words(a, b)
    for unroll in (False, True):
        assert torch.equal(probes.myers_eq_scan(eq, la, lb, unroll),
                           probes.myers_eq_scan_plain(eq, la, lb, unroll))
    assert torch.equal(probes.myers_ineq(a, b, la, lb), probes.myers_ineq_plain(a, b, la, lb))
    assert torch.equal(probes.myers_swar(a, b, la, lb), probes.myers_swar_plain(a, b, la, lb))
    for g, w in zip(probes.fused_lev_jaro(a, b, la, lb), probes.fused_lev_jaro_plain(a, b, la, lb)):
        assert torch.equal(g, w)
    assert _build.launch_counts() == {}


def test_probe_bounds():
    """K17 and K18 take K1's bound; K19 K5's lev + m + t (no inter, no
    prefix); K16 its own: 4 bytes of Eq word a text step, the two lengths
    and the output, and K1's 17 Myers operations a word and step without
    the table's build or reads."""
    lens = np.array([[20, 0, 32], [7, 5, 31]])
    clock = 1.98e9
    k1 = roofline.bound("levenshtein_myers", {}, lens, 1, 4, clock)
    for name in ("myers_ineq", "myers_swar"):
        assert roofline.bound(name, {}, lens, 1, 4, clock) == k1
    # rows (20, 7), (0, 5), (32, 31): words of a 1, 0, 1
    assert roofline.work_ops("myers_eq_scan", {}, lens[0], lens[1]) == 17 * 7 + 0 + 17 * 31
    ms, by = roofline.bound("myers_eq_scan", {}, lens, 1, 4, clock)
    t_ops = (17 * 7 + 17 * 31) / (roofline.INT32_LANES * clock)
    t_bytes = (4 * 7 + 8 + 4 + 4 * 5 + 8 + 4 + 4 * 31 + 8 + 4) / roofline.HBM_BYTES_PER_S
    assert (ms, by) == (max(t_ops, t_bytes) * 1e3, "bytes")
    # K19: K5's count less the capped prefix min(la, lb, 4)
    k5 = roofline.work_ops("lev_jaro_fused", {}, lens[0], lens[1])
    assert roofline.work_ops("fused_lev_jaro", {}, lens[0], lens[1]) == k5 - (4 + 0 + 4)


# --- the entry point -------------------------------------------------------------

def _tool_run(*args):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "tools/ab_torch_myers.py", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_tool_cpu_smoke(tmp_path):
    out = tmp_path / "ab.json"
    res = _tool_run("--device", "cpu", "--out", str(out))
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["parity"] == "exact" and line["cases"] == 4
    assert set(line["baseline_over_arm"].values()) == {"not measured"}
    d = json.loads(out.read_text())
    assert [c["probe"] for c in d["cases"]] == ["pallas", "pallas", "swar", "fused_lj"]
    for case in d["cases"]:
        assert case["parity"] == "exact" and case["rows"] == 512
        assert all(v["ms"] == "not measured" for v in case["baselines"].values())
        assert all(arm == {"ms": "not measured"} for arm in case["arms"].values())
    assert set(d["cases"][0]["arms"]) == {"scan", "unroll", "scan_with_build", "unroll_with_build",
                                          "ineq"}
    assert set(d["cases"][-1]["baselines"]) == {"separate", "k1", "k2", "k5"}


def test_tool_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _tool_run("--probes", "swar")
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_probes_and_tool_import_neither_jax_nor_strsim_tpu(tmp_path):
    code = (
        "import sys, runpy\n"
        "import strsim_tpu_torch.probes.myers\n"
        f"sys.argv = ['ab_torch_myers.py', '--device', 'cpu', '--probes', 'swar', '--out', {str(tmp_path / 'x.json')!r}]\n"
        "try:\n"
        "    runpy.run_path('tools/ab_torch_myers.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'strsim_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "clean"
    csrc = ROOT / "strsim_tpu_torch" / "csrc"
    sources = [csrc / "probe_myers.cu", csrc / "probe_fused_lj.cu",
               ROOT / "tools" / "ab_torch_myers.py", ROOT / "strsim_tpu_torch" / "probes" / "myers.py"]
    for path in sources:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "import strsim_tpu\n" not in text and "from strsim_tpu " not in text, path
        assert "from strsim_tpu." not in text and "import strsim_tpu." not in text, path
