#!/usr/bin/env python3
"""A/B of the multiset probes K20-K22 against the production multiset
kernels K3 and K4 on one CUDA GPU: the port of tools/ab_multiset_pallas.py
and ab_multiset_r3.py.

    python3 tools/ab_torch_multiset.py                     # both, full size
    python3 tools/ab_torch_multiset.py --probes r3         # one of them
    python3 tools/ab_torch_multiset.py --quick --trips 2,6 # one width a probe
    python3 tools/ab_torch_multiset.py --device cpu        # flow smoke on the CPU

Probes, named after the TPU tools they port
(`strsim_tpu_torch/probes/multiset.py`):
  pallas  K20 "select" (ab_multiset_pallas.py's `_kernel`: compare, select,
          add, all unrolled); w15 (the tool's width) and w7;
  r3      K20 "tree" and "astype", K21 (four chars a word, int8 only), K22
          with 4 and 8 a-positions a read (the tool's "blocked4",
          "blocked8"); w15, w31, w63 (the tool's widths) and w7, where
          K18's SWAR words beat K1's table (PERF.md, section 6).
Both on the tools' `make_inputs`: seed 0 a width, chars 97..122, lengths
uniform in 1..w, -1 / -2 past them; 262,144 rows a block, the TPU tools'
own BLOCK; int8 tiles, and int32 tiles of the same codes for every arm but
K21. `--quick`: w15 alone. The TPU tools' `block_rows` sweeps (8192 and
32768 in ab_multiset_pallas.py, "swar/br16k" in ab_multiset_r3.py) are
grid blocks with no counterpart on the card: every kernel here gives a row
a thread, 128 threads a block.

Per case, on tiles staged on the card: parity first. Each arm equals its
plain version, ops/multiset_cuda.py:rank_plain, K3
(multiset_intersection_rank) and, on int8, K4 (multiset_intersection_hist)
on every row; a mismatch raises (non-zero exit). Then the device time of a
call (utils/devicetime.py:marginal_block_time, `--trips C1,C2` fixes its
two trip counts) of K3, K4 and each arm on the same tiles: ms, K3 / arm and
K4 / arm, ns a pair, the bound (ops/roofline.py, K3's) and the share bound
/ time. A full run on the card also reads the SASS of the built library
(`cuobjdump -sass`): each K20 kernel's instruction count, and whether
"select" and "astype" compiled to the same instructions.

Writes chiprun_out/ab_torch_multiset.json (`--out`) with the card's name and
power limit (nvidia-smi); the last line of stdout is one JSON summary.
Without a CUDA device it exits non-zero unless --device cpu is given: 512
rows, w15, the plain versions, and no times ("not measured"). Imports torch,
strsim_tpu_torch and tools/ab_torch_myers.py (its timer and checks) only.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tools")]

from ab_torch_myers import NOT_MEASURED, Timer, _check_equal, _entry  # noqa: E402

PROBES = ("pallas", "r3")
TPU_TOOLS = {"pallas": "tools/ab_multiset_pallas.py", "r3": "tools/ab_multiset_r3.py"}
WIDTHS = {"pallas": (15, 7), "r3": (15, 31, 63, 7)}
QUICK = 15
ROWS = 262144
CPU_ROWS = 512


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--probes", default=",".join(PROBES))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--trips", default=None, help="C1,C2: marginal_block_time's two trip counts")
    p.add_argument("--out", default=str(REPO / "chiprun_out" / "ab_torch_multiset.json"))
    args = p.parse_args(argv)
    args.probes = args.probes.split(",")
    unknown = sorted(set(args.probes) - set(PROBES))
    if unknown:
        p.error(f"unknown probes {unknown}; choose from {PROBES}")
    if args.device == "cpu":
        args.quick = True
    args.rows = CPU_ROWS if args.device == "cpu" else ROWS
    return args


def make_inputs(rows: int, width: int, seed: int = 0):
    """([rows, 2 * width] int32 codes, [2, rows] int32 lengths): the TPU
    tools' make_inputs (ab_multiset_pallas.py:92, ab_multiset_r3.py:209) at
    `rows` rows, padded past the lengths with -1 (a) and -2 (b)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(97, 123, size=(rows, 2 * width), dtype=np.int32)
    lens = rng.integers(1, width + 1, size=(rows, 2), dtype=np.int32)
    pos = np.arange(width)[None, :]
    codes[:, :width][pos >= lens[:, :1]] = -1
    codes[:, width:][pos >= lens[:, 1:2]] = -2
    return codes, np.ascontiguousarray(lens.T)


def arms(probe: str, dtype: str) -> dict:
    """name -> (fn(a, b, la), plain(a, b, la)) of a probe's arms."""
    from functools import partial

    from strsim_tpu_torch.probes import multiset as ms

    def unrolled(mode):
        return (partial(ms.multiset_unrolled, mode=mode),
                partial(ms.multiset_unrolled_plain, mode=mode))

    if probe == "pallas":
        return {"select": unrolled("select")}
    out = {"tree": unrolled("tree"), "astype": unrolled("astype")}
    if dtype == "int8":
        out["swar"] = (ms.multiset_swar, ms.multiset_swar_plain)
    for gi in ms.GROUPS:
        out[f"blocked{gi}"] = (partial(ms.multiset_blocked, gi=gi),
                               partial(ms.multiset_blocked_plain, gi=gi))
    return out


def run_case(probe, width, dtype, codes, lens, args, device, timer, clock_hz) -> dict:
    """One probe at one width and dtype: parity, then the times."""
    import torch

    from strsim_tpu_torch.ops import multiset_cuda
    from strsim_tpu_torch.ops.roofline import bound

    c = torch.from_numpy(codes.astype(np.int8 if dtype == "int8" else np.int32)).to(device)
    lt = torch.from_numpy(lens).to(device)
    a, b, la, lb = tiles = (c[:, :width], c[:, width:], lt[0], lt[1])
    label = f"{probe} w{width} {dtype}"
    elem = 1 if dtype == "int8" else 4
    baselines = {"k3": multiset_cuda.multiset_intersection_rank}
    if dtype == "int8":
        baselines["k4"] = multiset_cuda.multiset_intersection_hist
    refs = {"rank_plain": multiset_cuda.rank_plain(*tiles),
            **{name: fn(*tiles) for name, fn in baselines.items()}}
    probe_arms = arms(probe, dtype)
    for name, (fn, plain) in probe_arms.items():
        got = fn(a, b, la)
        _check_equal(f"{label} {name} vs its plain version", ("inter",), (got,),
                     (plain(a, b, la),), lens)
        for ref, want in refs.items():
            _check_equal(f"{label} {name} vs {ref}", ("inter",), (got,), (want,), lens)

    # every arm takes K3's bound (ops/roofline.py:work_ops maps K20-K22 to it)
    b_ms, b_by = (bound("multiset_rank", {}, lens, elem, 4, clock_hz) if timer.on_card
                  else (NOT_MEASURED, NOT_MEASURED))
    base_ms = {name: timer(fn, tiles) for name, fn in baselines.items()}
    rec = {"probe": probe, "tpu_tool": TPU_TOOLS[probe], "width": width, "dtype": dtype,
           "rows": args.rows, "parity": "exact", "bound_ms": b_ms, "bound_by": b_by,
           "baselines": {name: _entry(ms, args.rows, b_ms) for name, ms in base_ms.items()},
           "arms": {}}
    for name, (fn, _) in probe_arms.items():
        ms = timer(lambda *t, f=fn: f(*t[:3]), tiles)
        rec["arms"][name] = _entry(ms, args.rows, b_ms, base_ms if timer.on_card else None)
    return rec


def sass_report() -> dict:
    """Instruction counts of the built K20 kernels from `cuobjdump -sass`,
    by (dtype, width), and whether "select" and "astype" are the same
    instructions; {"error": ...} where that cannot be read."""
    from strsim_tpu_torch.ops import _build
    from strsim_tpu_torch.probes.multiset import MODES

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"error": "cuobjdump not found"}
    _build.library("probe_multiset")
    dump = subprocess.run([tool, "-sass", str(_build._target("probe_multiset"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    bodies, name = {}, None
    for line in dump.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            bodies[name] = []
        elif name is not None:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
            if ins:
                bodies[name].append(" ".join(ins.group(1).split()))
    modes = {}  # (dtype, L) -> {mode index: instructions}
    for name, body in bodies.items():
        # unrolled_kernel<T, L, (Accum)m> mangles as ...15unrolled_kernelI{a|i}Li<L>EL...E<m>E...
        m = re.search(r"15unrolled_kernelI([ai])Li(\d+)EL\w*?E(\d)E", name)
        if m:
            dtype = "int8" if m.group(1) == "a" else "int32"
            modes.setdefault((dtype, int(m.group(2))), {})[int(m.group(3))] = body
    if not modes:
        return {"error": "no unrolled_kernel in the SASS", "functions": sorted(bodies)[:6]}
    return {f"{dtype} w{width}": {**{f"{MODES[i]}_instructions": len(v)
                                     for i, v in sorted(by.items())},
                                  "select_same_as_astype": by.get(0) == by.get(2)}
            for (dtype, width), by in sorted(modes.items())}


def _line(rec) -> str:
    def f(x):
        return x if isinstance(x, str) else f"{x:.4f}"

    base = ", ".join(f"{k} {f(v['ms'])}" for k, v in rec["baselines"].items())
    arms_ = "; ".join(f"{k} {f(v['ms'])} ms" + "".join(
        f" ({r[:-len('_over_arm')]}/arm {x:.3f})" for r, x in v.items() if r.endswith("_over_arm"))
        for k, v in rec["arms"].items())
    return (f"  {rec['probe']:6s} w{rec['width']:<3d} {rec['dtype']:5s} exact; {base} ms; {arms_}; "
            f"bound {f(rec['bound_ms'])} ms")


def main(argv) -> int:
    args = _parse(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ab_torch_multiset: no CUDA device (pass --device cpu for the CPU smoke)",
              file=sys.stderr)
        return 2
    from strsim_tpu_torch.ops.roofline import card_line, max_sm_clock_hz

    on_card = args.device == "cuda"
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    card = card_line() if on_card else "cpu"
    clock_hz = max_sm_clock_hz() if on_card else 0.0
    trips = tuple(int(x) for x in args.trips.split(",")) if args.trips else None
    timer = Timer(on_card, trips, clock_hz)
    t0 = time.perf_counter()
    print(f"ab_torch_multiset: {card}, {args.rows} rows a block, probes {','.join(args.probes)}",
          flush=True)
    records = []
    for probe in args.probes:
        for width in WIDTHS[probe]:
            if args.quick and width != QUICK:
                continue
            codes, lens = make_inputs(args.rows, width)  # a fresh seed a width, as the tools
            for dtype in ("int8", "int32"):
                rec = run_case(probe, width, dtype, codes, lens, args, device, timer, clock_hz)
                records.append(rec)
                print(_line(rec), flush=True)
    sass = sass_report() if on_card and not args.quick else NOT_MEASURED
    if isinstance(sass, dict):
        for key, v in sass.items():
            print(f"  sass {key}: {v}", flush=True)
    reduced = []
    if args.rows != ROWS:
        reduced.append(f"{args.rows} rows a block (TPU run {ROWS})")
    if args.quick:
        reduced.append(f"one width: w{QUICK}")
    details = {"device": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "rows": args.rows, "trips": trips, "reduced": reduced, "cases": records,
               "sass": sass, "wall_s": time.perf_counter() - t0}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(details, indent=1))
    ratios = {}  # "<case> <arm> vs <baseline>": baseline ms / arm ms
    for r in records:
        for arm, v in r["arms"].items():
            over = {k[:-len("_over_arm")]: x for k, x in v.items() if k.endswith("_over_arm")}
            for base, x in (over or {"baseline": NOT_MEASURED}).items():
                ratios[f"{r['probe']} w{r['width']} {r['dtype']} {arm} vs {base}"] = x
    summary = {"tool": "ab_torch_multiset", "device": card, "rows": args.rows,
               "cases": len(records), "parity": "exact",
               "out": os.path.relpath(out, REPO) if out.is_absolute() else str(out),
               "baseline_over_arm": ratios}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
