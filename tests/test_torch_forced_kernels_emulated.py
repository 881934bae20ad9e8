"""The forced path's kernels K9 (`csrc/jaro_flags.cu`, K2's kernel of
`csrc/jaro_body.cuh` cut to the scan and its flags) and K10
(`csrc/levenshtein_wavefront.cu`: one row pair a lane in 32-bit cells, two in
16-bit halves on int8 rows wider than 16 chars) run on the CPU against their
plain versions.

The sources are compiled with g++ against `tests/cuda_emulation/cuda_runtime.h`
as `tests/test_torch_lane_kernels_cpu.py` compiles the lane-group kernels
(one thread per CUDA thread, each warp collective a rendezvous of its
lanes). The C entry points take tiles from `chip_smoke.make_tiles` (the lane rows and every
word-boundary length among them) at a width of every instantiation, int8
and int32, packed as the pipeline packs them and as separate tiles, with
rows put at every strip boundary of K10 (K * l - 1, K * l, K * l + 1), sides
of length 0 and 1, lengths out of range and a last warp short of rows.
Exactly: K10's distances equal `wavefront_plain`'s, and K9's (m, matched,
flagged) `jaro_cuda.greedy_scan`'s, every byte, with the bytes past the
lengths zero and the bytes around each output untouched. The shim's
stand-ins for the DPX intrinsics are held to their definitions first. Skipped without g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from strsim_tpu_torch.ops import _build, jaro_cuda
from strsim_tpu_torch.ops.levenshtein_wavefront_cuda import wavefront_plain
from test_torch_lane_kernels_cpu import CSRC, SHIM, _for_the_cpu
from torch_tiles import make_packed_tiles

# a width of every instantiation of K10 (G = 1 with K = 8 and 16; G = 2, 4,
# 8, 16, 32 with K = 12 and 16) and of K2's body that K9 runs (G = 1 with 8,
# 16 and 32 chars a lane, the int8 table from 17; G = 2, 4, 8, 16)
WAVEFRONT_WIDTHS = [7, 16, 23, 31, 47, 64, 95, 128, 191, 255, 383, 512]
FLAG_WIDTHS = [7, 15, 31, 33, 64, 95, 200, 511]
INTRINSICS = r"""
#include <cuda_runtime.h>
extern "C" int emu_viaddmin_s32(int a, int b, int c) { return __viaddmin_s32(a, b, c); }
extern "C" unsigned emu_viaddmin_s16x2(unsigned a, unsigned b, unsigned c) {
  return __viaddmin_s16x2(a, b, c);
}
extern "C" unsigned emu_vimin3_u16x2(unsigned a, unsigned b, unsigned c) {
  return __vimin3_u16x2(a, b, c);
}
"""


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{name: ctypes library}: jaro_flags.cu, levenshtein_wavefront.cu
    ("wavefront") and the intrinsics."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("forced_kernels")
    for path in CSRC.glob("*.cu*"):
        (out / path.name).write_text(_for_the_cpu(path.read_text()))
    (out / "intrinsics.cu").write_text(INTRINSICS)
    sources = {"jaro_flags": "jaro_flags", "wavefront": "levenshtein_wavefront",
               "intrinsics": "intrinsics"}
    procs = {name: subprocess.Popen(
        [gxx, "-std=c++17", "-O1", "-pthread", "-shared", "-fPIC", f"-I{SHIM}", f"-I{out}",
         "-x", "c++", "-o", str(out / f"{name}.so"), str(out / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, src in sources.items()}
    loaded = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ {name}:\n{log[-4000:]}"
        loaded[name] = ctypes.CDLL(str(out / f"{name}.so"))
    for name, library in (("jaro_flags", "jaro_flags"), ("wavefront", "levenshtein_wavefront")):
        for fn, argtypes in _build.LIBRARIES[library][1].items():
            getattr(loaded[name], fn).argtypes = argtypes
            getattr(loaded[name], fn).restype = ctypes.c_int
    i, u = ctypes.c_int, ctypes.c_uint
    for fn, t in (("emu_viaddmin_s32", i), ("emu_viaddmin_s16x2", u), ("emu_vimin3_u16x2", u)):
        f = getattr(loaded["intrinsics"], fn)
        f.argtypes, f.restype = [t] * 3, t
    return loaded


def _s16(x):
    return (x & 0xFFFF) - ((x & 0x8000) << 1)


def test_intrinsic_stand_ins_match_their_definitions(libs):
    """__viaddmin_s32(a, b, c) = min(a + b, c), the sum wrapping in 32
    bits; __viaddmin_s16x2 the same in each signed 16-bit half, a half's sum
    wrapping on its own (overflow goes negative, no carry into the other
    half); __vimin3_u16x2 the least of three in each unsigned half."""
    lib = libs["intrinsics"]
    rng = np.random.default_rng(13)
    edge32 = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 1024, -5]
    for a, b, c in [*((x, y, z) for x in edge32 for y in edge32 for z in edge32[:3]),
                    *rng.integers(-2 ** 31, 2 ** 31, (200, 3)).tolist()]:
        s = (a + b + 2 ** 31) % 2 ** 32 - 2 ** 31
        assert lib.emu_viaddmin_s32(a, b, c) == min(s, c), (a, b, c)
    edge16 = [0, 1, 0x7FFF, 0x8000, 0xFFFF, 0x7FFE, 0x4000, 3]
    words = [h | lo << 16 for h in edge16 for lo in edge16]
    for a, b, c in [*((x, y, z) for x in words[::5] for y in words[::3] for z in words[::7]),
                    *rng.integers(0, 2 ** 32, (300, 3)).tolist()]:
        want = 0
        for k in (0, 16):
            s = _s16(((a >> k) + (b >> k)) & 0xFFFF)
            want |= (min(s, _s16(c >> k)) & 0xFFFF) << k
        assert lib.emu_viaddmin_s16x2(a, b, c) == want, (hex(a), hex(b), hex(c))
    for a, b, c in [*((x, y, z) for x in words[::2] for y in words[::5] for z in words[::11]),
                    *rng.integers(0, 2 ** 32, (300, 3)).tolist()]:
        want = sum(min((a >> k) & 0xFFFF, (b >> k) & 0xFFFF, (c >> k) & 0xFFFF) << k for k in (0, 16))
        assert lib.emu_vimin3_u16x2(a, b, c) == want, (hex(a), hex(b), hex(c))


def _strip(width):
    """(G, K) of K10's instantiation for `width` (csrc/levenshtein_wavefront.cu:
    wavefront_select)."""
    if width <= 16:
        return 1, 8 if width <= 8 else 16
    g = 2
    while 16 * g < width:
        g *= 2
    return g, 12 if width <= 12 * g else 16


def _edge_tiles(width, dtype, packed, tile_rows, strips):
    """`tile_rows` rows of chip_smoke.make_tiles (its first rows take the
    lengths 0, 1, 2, width - 1, width and 32k - 1, 32k, 32k + 1), then, if
    `strips`, la at every strip boundary K * l - 1, K * l, K * l + 1 of K10's
    instantiation (lb short, or equal to la near the first and last strips), then sides of length 0 and 1
    (la + lb <= 1 among them) and lengths out of range, chars drawn over a
    small alphabet and padded as make_tiles pads; an odd row count, so that
    the last warp is short of rows. Packed as the pipeline packs a bucket,
    or as separate tiles."""
    rng = np.random.default_rng(width * 7 + tile_rows)
    codes, lens = make_packed_tiles(rng, tile_rows, width, dtype)
    pairs = []
    if strips:
        g, k = _strip(width)
        at = sorted({k * l + d for l in range(1, g + 1) for d in (-1, 0, 1) if 1 <= k * l + d <= width})
        # long rows only near the first and the last strips: the emulation's
        # time goes as the steps, lb + la / K
        pairs += [(x, x if min(x, width - x) <= 3 * k and i % 2 == 0 else int(rng.integers(1, 7)))
                  for i, x in enumerate(at)]
    pairs += [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0), (1, width), (width, 1),
              (width + 1, 3), (3, width + 1), (-1, 2), (2, -3), (width + 7, width + 7)]
    if (tile_rows + len(pairs)) % 2 == 0:
        pairs.append((width, width))
    la, lb = np.array(pairs, dtype=np.int64).T
    a, b = rng.integers(97, 101, (2, len(pairs), width))
    pos = np.arange(width)[None, :]
    a[pos >= la[:, None]] = -1
    b[pos >= lb[:, None]] = -2
    codes = torch.from_numpy(np.concatenate([codes, np.concatenate([a, b], 1).astype(dtype)]))
    lens = np.concatenate([lens, np.stack([la, lb]).astype(np.int32)], 1)
    a, b = codes[:, :width], codes[:, width:]
    if not packed:
        a, b = a.contiguous(), b.contiguous()
    return a, b, torch.from_numpy(lens[0].copy()), torch.from_numpy(lens[1].copy())


def _call(lib, fn, a, b, la, lb, *outs):
    n, width = a.shape
    return getattr(lib, fn)(a.data_ptr(), b.data_ptr(), a.stride(0), b.stride(0), la.data_ptr(),
                            lb.data_ptr(), *outs, n, width, a.element_size(), None)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", WAVEFRONT_WIDTHS)
def test_wavefront_matches_plain(libs, width, dtype, packed):
    """int8 rows wider than 16 chars take the 16-bit pair form, two row
    pairs a lane (the row count is odd: a lane's second row is missing at
    the end); the others one row pair a lane."""
    a, b, la, lb = _edge_tiles(width, dtype, packed, 12, strips=True)
    n = a.shape[0]
    buf = torch.full((n + 8,), -12345, dtype=torch.int32)
    assert _call(libs["wavefront"], "strsim_levenshtein_wavefront", a, b, la, lb,
                 buf[4:].data_ptr()) == 0
    assert torch.equal(buf[4:4 + n], wavefront_plain(a, b, la, lb))
    assert (buf[:4] == -12345).all() and (buf[4 + n:] == -12345).all()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", FLAG_WIDTHS)
def test_jaro_flags_match_greedy_scan(libs, width, dtype, packed):
    """make_tiles's rows past its edge rows too; the flag tensors start 1
    and 7 bytes past a 16-byte boundary (the stores' head, body and tail), in
    a buffer whose bytes around them must stay as they were."""
    a, b, la, lb = _edge_tiles(width, dtype, packed, 3 * (width // 32) + 16, strips=False)
    n = a.shape[0]
    want_m, want_matched, want_flagged = jaro_cuda.greedy_scan(a, b, la, lb)
    m = torch.full((n,), -7, dtype=torch.int32)
    buf = torch.full((2 * n * width + 64,), 0x5A, dtype=torch.uint8)
    assert buf.data_ptr() % 16 == 0
    at_m, at_f = 1, n * width + 23  # 1 and 7 bytes past a boundary
    assert _call(libs["jaro_flags"], "strsim_jaro_flags", a, b, la, lb, m.data_ptr(),
                 buf.data_ptr() + at_m, buf.data_ptr() + at_f) == 0
    assert torch.equal(m, want_m)
    matched = buf[at_m:at_m + n * width].view(n, width)
    flagged = buf[at_f:at_f + n * width].view(n, width)
    assert torch.equal(matched, want_matched.to(torch.uint8))
    assert torch.equal(flagged, want_flagged.to(torch.uint8))
    pos = torch.arange(width)[None, :]
    assert not matched[pos >= la.clamp(0, width)[:, None]].any()
    assert not flagged[pos >= lb.clamp(0, width)[:, None]].any()
    untouched = torch.ones_like(buf, dtype=torch.bool)
    untouched[at_m:at_m + n * width] = False
    untouched[at_f:at_f + n * width] = False
    assert (buf[untouched] == 0x5A).all()


@pytest.mark.parametrize("width", [0, 513])
def test_forced_kernels_refuse_widths_outside_the_ladder(libs, width):
    a = torch.zeros((4, max(width, 1)), dtype=torch.int8)
    la = torch.zeros(4, dtype=torch.int32)
    out = torch.empty(4 * 513, dtype=torch.int32)
    for lib, fn, outs in ((libs["jaro_flags"], "strsim_jaro_flags", 3),
                          (libs["wavefront"], "strsim_levenshtein_wavefront", 1)):
        assert getattr(lib, fn)(a.data_ptr(), a.data_ptr(), a.stride(0), a.stride(0),
                                la.data_ptr(), la.data_ptr(), *[out.data_ptr()] * outs, 4, width,
                                1, None) != 0
