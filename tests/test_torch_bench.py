"""The benchmark entry point and what it stands on, on the CPU: K11's plain
version against row 11's Pallas body in interpret mode; no CPU fallback in
K11's wrapper or the device timing; the H100 bound of ops/roofline.py on
hand-worked cases, with no second copy in chip_smoke.py; bench_torch.py's
CPU smoke and its refusal without a card; and the imports of the port's new
modules."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from strsim_tpu_torch.native import build as native_build
from strsim_tpu_torch.ops import roofline
from strsim_tpu_torch.ops.warm_cuda import warm, warm_plain
from strsim_tpu_torch.utils.devicetime import marginal_block_time

torch.set_num_threads(1)  # keep torch's pool off the other test workers' cores

ROOT = Path(__file__).resolve().parents[1]


def _row_11_kernel(x_ref, o_ref):
    """bench.py:685-687, the body of the kernel that bench.py compiles
    first (it is nested in _mosaic_init_warm, which returns early off a
    TPU, so the test writes it out)."""
    o_ref[...] = x_ref[...] * 2 + 1


@pytest.mark.parametrize("seed", [0, 1])
def test_warm_plain_matches_row_11_in_interpret_mode(seed):
    x = np.random.default_rng(seed).integers(-2 ** 31, 2 ** 31, (8, 128)).astype(np.int32)
    x[0, :4] = [0, -1, 2 ** 31 - 1, -2 ** 31]  # wraps
    want = pl.pallas_call(_row_11_kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
                          interpret=True)(jnp.asarray(x))
    got = warm_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_no_cpu_fallback_for_the_kernel_or_the_device_time():
    """K11's wrapper and the device timing raise on CPU tensors instead of
    computing: a CPU run has neither a kernel launch nor a device time."""
    x = torch.ones((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        warm(x)
    with pytest.raises(ValueError, match="CUDA"):
        marginal_block_time(lambda t: t * 2, [(x,), (x,)])


def test_bound_on_hand_worked_cases():
    clock = 1.98e9
    peak_ops = 132 * 64 * clock
    # K1, la = 40, lb = 33: two pattern words; the table's 40 ORs and 2 x 33
    # reads, 17 operations a word and step: 40 + 66 + 17 * 2 * 33 = 1228
    lens = np.array([[40], [33]])
    assert roofline.work_ops("levenshtein_myers", {}, lens[0], lens[1]) == 1228
    ms, by = roofline.bound("levenshtein_myers", {}, lens, 1, 4, clock)
    assert by == "operations" and ms == pytest.approx(1228 / peak_ops * 1e3, rel=1e-12)
    # K4 on int32, la = lb = 10: 40 operations, (10 + 10) * 4 + 8 + 4 = 92 bytes
    lens = np.array([[10], [10]])
    ms, by = roofline.bound("multiset_hist", {}, lens, 4, 4, clock)
    assert by == "bytes" and ms == pytest.approx(92 / 3.35e12 * 1e3, rel=1e-12)
    # K11 over [8, 128]: 8 bytes an element
    ms, by = roofline.warm_bound(1024, clock)
    assert by == "bytes" and ms == pytest.approx(8192 / 3.35e12 * 1e3, rel=1e-12)


def test_roofline_report_sums_the_routed_kernels():
    lens = (np.array([40, 12]), np.array([33, 12]))
    routes = {"lev_d": "levenshtein_myers", "inter": "multiset_rank", "prefix": "plain"}
    report = roofline.roofline_report(
        [{"width": 47, "dtype": "int8", "lens": lens, "routes": routes, "fields": ("inter", "lev_d"),
          "measured_ms": 0.5}], 1.98e9)
    la, lb = (np.asarray(x, np.int64) for x in lens)
    ops = roofline.work_ops("levenshtein_myers", {}, la, lb) + roofline.work_ops("multiset_rank", {}, la, lb)
    bucket = report["buckets"][47]
    assert bucket["bound_ms"] == pytest.approx(ops / (132 * 64 * 1.98e9) * 1e3, rel=1e-12)
    assert bucket["kernels"] == ["levenshtein_myers", "multiset_rank"]
    assert report["share"] == pytest.approx(bucket["bound_ms"] / 0.5)


def test_chip_smoke_holds_no_second_copy_of_the_bound():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    source = (ROOT / "chip_smoke.py").read_text()
    for name in ("work_ops", "bound", "route_flags", "HBM_BYTES_PER_S", "INT32_LANES", "MYERS_OPS"):
        assert not hasattr(chip_smoke, name), name
        assert not re.search(rf"^(def {name}\b|{name} =)", source, re.M), name
    assert "warm" in chip_smoke.KERNELS and len(chip_smoke.KERNELS) == 23  # K1-K11, K12-K22, K23


_POOL_THEN_STOP = """
import multiprocessing, os, pathlib, sys
import multiprocessing.resource_tracker as rt
if {no_exit_stop}:
    del rt.ResourceTracker.__del__  # as an interpreter that leaves the tracker to end by itself
sys.path.insert(0, {root!r})
import chip_smoke

def main():
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        assert pool.map(abs, [-1, 2]) == [1, 2]
        pool.close()
        pool.join()
        print(rt._resource_tracker._pid, flush=True)
    del pool
    chip_smoke.stop_children()
    me = str(os.getpid())
    left = [s.parent.name for s in pathlib.Path("/proc").glob("[0-9]*/stat")
            if s.exists() and s.read_text().rsplit(")", 1)[1].split()[1] == me]
    assert not left and rt._resource_tracker._pid is None, left

if __name__ == "__main__":
    try:
        main()
    finally:
        chip_smoke.stop_children()
"""


@pytest.mark.parametrize("no_exit_stop", [False, True])
def test_chip_smoke_leaves_no_process_behind(tmp_path, no_exit_stop):
    script = tmp_path / "pool_then_stop.py"
    script.write_text(_POOL_THEN_STOP.format(no_exit_stop=no_exit_stop, root=str(ROOT)))
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    tracker = int(res.stdout.split()[0])
    assert not Path(f"/proc/{tracker}").exists()  # gone the moment the script has exited


def test_bench_torch_cpu_smoke(tmp_path):
    details = tmp_path / "details.json"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "bench_torch.py", "--device", "cpu", "--n-pairs", "2000",
                          "--details", str(details)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["metric"] == "levenshtein_pairs_per_sec"
    assert line["unit"] == "pairs/s" and line["value"] > 0 and line["vs_baseline"] > 0
    d = json.loads(details.read_text())
    assert set(d["measures"]) == {"levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice"}
    for section in (*d["measures"].values(), d["fused"]):
        assert all(section["bit_exact_parity"].values()) and section["bit_exact_parity"]
        assert len(section["pairs_per_sec"]) == 5 and section["encode_route"] == "native_objects"
        assert section["resident_pairs_per_sec"] == "not measured"
    assert d["encode"]["equal"] and d["crossover"] == "not measured"
    assert d["first_launch_ms"] == "not measured" and "native" in d["kernel_build_s"]


def test_bench_torch_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "metric" not in res.stdout


def test_new_modules_import_neither_jax_nor_strsim_tpu():
    code = (
        "import sys\n"
        "import bench_torch, chip_smoke, bench\n"
        "from strsim_tpu_torch import native\n"
        "from strsim_tpu_torch.native import binding, build\n"
        "from strsim_tpu_torch.ops import roofline, warm_cuda\n"
        "from strsim_tpu_torch.utils import alloc, devicetime, encode\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'strsim_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|strsim_tpu)\b", re.M)
    for path in [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
                 *(ROOT / "strsim_tpu_torch").rglob("*.py")]:
        assert not pattern.search(path.read_text()), path
    assert native_build.SRC.parent == ROOT / "strsim_tpu_torch" / "native"
