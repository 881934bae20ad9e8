"""The multiset probes K20-K22 of the port
(`strsim_tpu_torch/probes/multiset.py`) on the CPU.

Their plain versions against the TPU probes they port, run in interpret mode
on the same numpy-seeded inputs, exactly: `tools/ab_multiset_pallas.py`'s
`_kernel` and `tools/ab_multiset_r3.py`'s `_kernel_tree`, `_kernel_astype`,
`_kernel_swar` and `_kernel_blocked` (GI 4, and 8 at w7/w15), each in a
`pl.pallas_call` written out here at a 512-row block (the tools' wrappers
take no `interpret`), on the tools' generator with len-0 and len-1 rows put
in, at w7, w15 and w31, and `_kernel_astype` and `_kernel_swar` at w63.
Then the TPU SWAR body's fault, which the port does not carry: on NUL rows it
counts the zero fill bytes of b's last word as matches. Then the contracts:
on `chip_smoke.make_tiles` tiles (NUL chars, lane rows, word-boundary and
len-0/len-1 lengths) every plain version equals `rank_plain` at every narrow
width and dtype; K21 refuses int32 tiles; the wrappers check their
arguments and run their plain versions on CPU tensors; the K3 bound of
ops/roofline.py; and the entry point `tools/ab_torch_multiset.py` (its CPU
smoke, its refusal without a card, and its imports).
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
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from strsim_tpu_torch.ops import _build, multiset_cuda, roofline
from strsim_tpu_torch.probes import multiset as probes
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


def _inputs(width, seed=0):
    """The tools' make_inputs at ROWS rows (chars 97..122, lengths uniform
    in 1..width, int8), with len-0 and len-1 rows over the first 16 (la = 0
    against lb 0..3; len-1 against len-1, 2 and 0, both ways; equal chars in
    the first len-1/len-1 rows), then the pads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(97, 123, size=(ROWS, 2 * width), dtype=np.int32)
    lens = rng.integers(1, width + 1, size=(ROWS, 2), dtype=np.int32)
    lens[:4, 0], lens[:4, 1] = 0, np.arange(4)
    lens[4:10, 0], lens[4:10, 1] = 1, [1, 1, 1, 2, 0, 3]
    lens[10:16, 0], lens[10:16, 1] = [2, 0, 3, 1, 1, 1], 1
    codes[4:6, width] = codes[4:6, 0]
    return _pad(codes, lens, width).astype(np.int8), lens


def _pad(codes, lens, width):
    """PAD_A / PAD_B past each side's length, as the encoder pads."""
    pos = np.arange(width)[None, :]
    codes[:, :width][pos >= lens[:, :1]] = -1
    codes[:, width:][pos >= lens[:, 1:2]] = -2
    return codes


def _tpu_body(kernel, codes, lens, width):
    """`kernel` (a TPU body of a tool) as the tools' wrappers launch it, at
    one ROWS-row block, interpreted: [ROWS] int32."""
    br8 = ROWS // SUB

    def fold(x):  # [B, L] -> [1, L, 8, B / 8], the tools' block layout
        return jnp.asarray(x).T.astype(jnp.int32).reshape(width, 1, SUB, br8).transpose(1, 0, 2, 3)

    tile = pl.BlockSpec((1, width, SUB, br8), lambda g: (g, 0, 0, 0), memory_space=pltpu.VMEM)
    row = pl.BlockSpec((1, SUB, br8), lambda g: (g, 0, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(kernel, L=width),
        out_shape=jax.ShapeDtypeStruct((1, SUB, br8), jnp.int32),
        grid=(1,), in_specs=[tile, tile, row], out_specs=row, interpret=True,
    )(fold(codes[:, :width]), fold(codes[:, width:]), jnp.asarray(lens[:, 0]).reshape(1, SUB, br8))
    return np.asarray(out).reshape(ROWS)


def _port_tiles(codes, lens, width, dtype=torch.int8):
    c = torch.from_numpy(codes).to(dtype)
    return c[:, :width], c[:, width:], torch.from_numpy(lens[:, 0].copy())


def _same(got, want):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _r3(name, **kw):
    return functools.partial(getattr(_tool("ab_multiset_r3"), name), **kw)


# --- the plain versions against the TPU probes, interpreted --------------------
# (TPU body, the port's plain version, whether it takes int32 tiles too)

BODIES = {
    "pallas_kernel": (lambda: _tool("ab_multiset_pallas")._kernel,
                      functools.partial(probes.multiset_unrolled_plain, mode="select"), True),
    "tree": (lambda: _r3("_kernel_tree"),
             functools.partial(probes.multiset_unrolled_plain, mode="tree"), True),
    "astype": (lambda: _r3("_kernel_astype"),
               functools.partial(probes.multiset_unrolled_plain, mode="astype"), True),
    "swar": (lambda: _r3("_kernel_swar"), probes.multiset_swar_plain, False),
    "blocked4": (lambda: _r3("_kernel_blocked", GI=4),
                 functools.partial(probes.multiset_blocked_plain, gi=4), True),
    "blocked8": (lambda: _r3("_kernel_blocked", GI=8),
                 functools.partial(probes.multiset_blocked_plain, gi=8), True),
}
CASES = ([(body, w) for w in (7, 15, 31) for body in ("pallas_kernel", "tree", "astype", "swar",
                                                       "blocked4")]
         + [("blocked8", 7), ("blocked8", 15), ("astype", 63), ("swar", 63)])


@pytest.mark.parametrize("body,width", CASES, ids=[f"{b}-w{w}" for b, w in CASES])
def test_plain_matches_tpu_body(body, width):
    """Each plain version equals its TPU body on the tool's generator, on
    int8 tiles and (the compare bodies) on int32 tiles of the same codes."""
    kernel, plain, both = BODIES[body]
    codes, lens = _inputs(width)
    want = _tpu_body(kernel(), codes, lens, width)
    for dtype in (torch.int8, torch.int32) if both else (torch.int8,):
        _same(plain(*_port_tiles(codes, lens, width, dtype)), want)


def _nul_rows(width):
    """Rows with NUL chars: a = "\\0a", b = "ab"; a = "\\0\\0\\0", b = "\\0";
    then NUL-rich rows of chars {0, 97, 98} at random lengths."""
    rng = np.random.default_rng(5)
    codes = rng.choice(np.array([0, 97, 98]), size=(ROWS, 2 * width)).astype(np.int32)
    lens = rng.integers(0, width + 1, size=(ROWS, 2)).astype(np.int32)
    codes[0, :2], codes[0, width:width + 2], lens[0] = [0, 97], [97, 98], [2, 2]
    codes[1, :3], codes[1, width], lens[1] = 0, 0, [3, 1]
    return _pad(codes, lens, width).astype(np.int8), lens


def test_tpu_swar_body_overcounts_nul_where_the_port_does_not():
    """At w7 b's second word holds one unused byte. The TPU body leaves it 0,
    so a NUL a-char counts it as a match: "\\0a" against "ab" gives 2, and
    "\\0\\0\\0" against "\\0" gives 2, where the intersection is 1. K21's
    plain version fills it with 254 and equals rank_plain on every row."""
    width = 7
    codes, lens = _nul_rows(width)
    tpu_swar = _tpu_body(_r3("_kernel_swar"), codes, lens, width)
    tpu_astype = _tpu_body(_r3("_kernel_astype"), codes, lens, width)
    assert tpu_astype[:2].tolist() == [1, 1] and tpu_swar[:2].tolist() == [2, 2]
    assert (tpu_swar != tpu_astype).sum() > 50
    c = torch.from_numpy(codes)
    a, b = c[:, :width], c[:, width:]
    la, lb = (torch.from_numpy(lens[:, k].copy()) for k in (0, 1))
    want = multiset_cuda.rank_plain(a, b, la, lb)
    _same(want, tpu_astype)
    assert torch.equal(probes.multiset_swar_plain(a, b, la), want)
    assert torch.equal(probes.multiset_swar(a, b, la), want)


# --- contracts -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", probes.WIDTHS)
def test_plain_versions_equal_rank_plain(width, dtype):
    """On `chip_smoke.make_tiles` tiles, whose int8 alphabet holds NUL, every
    plain version equals K3's plain version on every row: b's pads past lb
    stand in for len_b."""
    a, b, la, lb = (torch.from_numpy(x) for x in make_tiles(width * 7 + 3, 300, width, dtype))
    if dtype == np.int8:
        assert bool((a == 0).any())
    want = multiset_cuda.rank_plain(a, b, la, lb)
    got = [probes.multiset_unrolled_plain(a, b, la, mode) for mode in probes.MODES]
    got += [probes.multiset_blocked_plain(a, b, la, gi) for gi in probes.GROUPS]
    if dtype == np.int8:
        got.append(probes.multiset_swar_plain(a, b, la))
    for g in got:
        assert torch.equal(g, want)


def test_swar_words_pack_four_bytes_with_the_pads():
    """Byte p of word w is char 4w + p; chars below 0 and the fill bytes
    past L take the side's pad byte."""
    x = torch.tensor([[1, -1, 3, 127, 0, -128, 5]], dtype=torch.int8)
    assert probes.swar_words(x, 0xFE).tolist() == [[0x7F03FE01, 0xFE05FE00]]
    assert probes.swar_words(x, 0xFF).tolist() == [[0x7F03FF01, 0xFF05FF00]]


def test_swar_refuses_int32_tiles():
    a, b, la, _ = (torch.from_numpy(x) for x in make_tiles(5, 16, 15, np.int32))
    for fn in (probes.multiset_swar, probes.multiset_swar_plain):
        with pytest.raises(TypeError, match="int8"):
            fn(a, b, la)


def test_wrappers_check_their_arguments():
    a, b, la, _ = (torch.from_numpy(x) for x in make_tiles(6, 16, 32, np.int8))
    for fn in (probes.multiset_unrolled, probes.multiset_swar, probes.multiset_blocked):
        with pytest.raises(ValueError, match="narrow ladder"):
            fn(a, b, la)
    a, b, la, _ = (torch.from_numpy(x) for x in make_tiles(6, 16, 95, np.int8))
    with pytest.raises(ValueError, match="outside"):
        probes.multiset_unrolled(a, b, la)
    a, b, la, _ = (torch.from_numpy(x) for x in make_tiles(6, 16, 15, np.int8))
    with pytest.raises(ValueError, match="mode"):
        probes.multiset_unrolled(a, b, la, "where")
    with pytest.raises(ValueError, match="gi"):
        probes.multiset_blocked(a, b, la, 6)
    with pytest.raises(ValueError, match="len_a"):
        probes.multiset_unrolled(a, b, la[:8])
    with pytest.raises(ValueError, match="contiguous"):
        probes.multiset_blocked(a.t(), b.t(), la)


def test_wrappers_run_their_plain_versions_on_cpu_tiles():
    """CPU tensors take the plain versions; nothing is launched or counted."""
    _build.reset_launch_counts()
    a, b, la, _ = (torch.from_numpy(x) for x in make_tiles(8, 64, 15, np.int8))
    for mode in probes.MODES:
        assert torch.equal(probes.multiset_unrolled(a, b, la, mode),
                           probes.multiset_unrolled_plain(a, b, la, mode))
    assert torch.equal(probes.multiset_swar(a, b, la), probes.multiset_swar_plain(a, b, la))
    for gi in probes.GROUPS:
        assert torch.equal(probes.multiset_blocked(a, b, la, gi),
                           probes.multiset_blocked_plain(a, b, la, gi))
    assert _build.launch_counts() == {}


def test_probe_bounds_are_k3s():
    """K20-K22 compute K3's function: its bound, 2 operations a char and
    the chars, lengths and output moved once."""
    lens = np.array([[20, 0, 63], [7, 5, 31]])
    clock = 1.98e9
    k3 = roofline.bound("multiset_rank", {}, lens, 4, 4, clock)
    for name in ("multiset_unrolled", "multiset_swar", "multiset_blocked"):
        assert roofline.work_ops(name, {"mode": "tree"}, lens[0], lens[1]) == 2 * (20 + 7 + 5 + 63 + 31)
        assert roofline.bound(name, {}, lens, 4, 4, clock) == k3


# --- the entry point -------------------------------------------------------------

def _tool_run(*args):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "tools/ab_torch_multiset.py", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_tool_cpu_smoke(tmp_path):
    out = tmp_path / "ab.json"
    res = _tool_run("--device", "cpu", "--out", str(out))
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["parity"] == "exact" and line["cases"] == 4
    assert set(line["baseline_over_arm"].values()) == {"not measured"}
    d = json.loads(out.read_text())
    assert [(c["probe"], c["dtype"]) for c in d["cases"]] == [
        ("pallas", "int8"), ("pallas", "int32"), ("r3", "int8"), ("r3", "int32")]
    for case in d["cases"]:
        assert case["parity"] == "exact" and case["rows"] == 512 and case["width"] == 15
        assert all(v["ms"] == "not measured" for v in case["baselines"].values())
        assert all(arm == {"ms": "not measured"} for arm in case["arms"].values())
    assert set(d["cases"][0]["arms"]) == {"select"}
    assert set(d["cases"][2]["arms"]) == {"tree", "astype", "swar", "blocked4", "blocked8"}
    assert set(d["cases"][2]["baselines"]) == {"k3", "k4"}
    assert set(d["cases"][3]["arms"]) == {"tree", "astype", "blocked4", "blocked8"}
    assert d["sass"] == "not measured"


def test_tool_generator_is_the_tpu_tools():
    """make_inputs draws as both TPU tools' make_inputs, rows for rows."""
    spec = importlib.util.spec_from_file_location("ab_torch_multiset",
                                                  ROOT / "tools" / "ab_torch_multiset.py")
    port = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(port)
    for tool in ("ab_multiset_pallas", "ab_multiset_r3"):
        mod = _tool(tool)
        packed, lens = mod.make_inputs(7)
        codes, lens_t = port.make_inputs(mod.BLOCK, 7)
        np.testing.assert_array_equal(codes.astype(np.int8), packed)
        np.testing.assert_array_equal(lens_t, lens.T)


def test_tool_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _tool_run("--probes", "r3")
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_probes_and_tool_import_neither_jax_nor_strsim_tpu(tmp_path):
    code = (
        "import sys, runpy\n"
        "import strsim_tpu_torch.probes.multiset\n"
        f"sys.argv = ['ab_torch_multiset.py', '--device', 'cpu', '--probes', 'pallas', '--out', {str(tmp_path / 'x.json')!r}]\n"
        "try:\n"
        "    runpy.run_path('tools/ab_torch_multiset.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'strsim_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "clean"
    sources = [ROOT / "strsim_tpu_torch" / "csrc" / "probe_multiset.cu",
               ROOT / "tools" / "ab_torch_multiset.py",
               ROOT / "strsim_tpu_torch" / "probes" / "multiset.py"]
    for path in sources:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "import strsim_tpu\n" not in text and "from strsim_tpu " not in text, path
        assert "from strsim_tpu." not in text and "import strsim_tpu." not in text, path
