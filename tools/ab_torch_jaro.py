#!/usr/bin/env python3
"""A/B of the jaro probes K12-K15 against the production jaro kernel K2 on
one CUDA GPU: the port of tools/ab_jaro_pallas.py, ab_jaro_wide.py,
ab_jaro_wide2.py and ab_jaro_sol_probe.py.

    python3 tools/ab_torch_jaro.py                           # all four, full size
    python3 tools/ab_torch_jaro.py --probes sol,wide2        # some of them
    python3 tools/ab_torch_jaro.py --quick --trips 2,6       # one width a probe
    python3 tools/ab_torch_jaro.py --probes sol --ladder     # K15 at every ladder width
    python3 tools/ab_torch_jaro.py --device cpu              # flow smoke on the CPU

Probes, named after the TPU tools they port (`strsim_tpu_torch/probes/jaro.py`):
  pallas  K12, the scan alone writing packed flag words, t outside it in
          plain torch, then the len-1/len-1 patch; w7, w15, w31, int8 and
          int32; lengths uniform in 1..w, chars 97..122, seed 0 a width;
  wide    K13, t on byte rank slots (patched in its wrapper); w95, w127,
          w255, w511, int8; the same generator;
  wide2   K14, words outside the window skipped (clip "warp": the warp's
          window union, as the TPU probe's block union; clip "row": the
          row's own window); w191, w383, w511, int8 and int32; the long side
          in [3L/4, L], the short side in 2..L, swapped half the time, seed
          23 over the widths in turn;
  sol     K15, K2's own kernel (csrc/jaro_body.cuh) in its four modes
          (full, no_tcount, scan_only, eqb_only); L = 15 and 31 with lengths
          L-7..L (seed 7), then w63, w255, w511 on wide2's lengths, and w511
          on int32; with --ladder at every width of the bucket ladder on
          int8 and int32 (the sol lengths up to w31, wide2's above), each
          case with K2's residency (blocks an SM, registers, local and
          shared memory).
Every generator pads past the lengths (-1 / -2) as the port's encoder does.
Rows: 65,536 a block; the TPU runs used 262,144 at w7..w31, a cut listed
under "reduced". `--quick`: one width a probe (w15, w255, w383, w31).

Per case, on tiles staged on the card: parity first, the probe's (m, t) on
every row, patched with ops/jaro_cuda.py:patch_one_one where the probe's
wrapper does not patch (K14, K15), equal to K2's; for sol each mode equal
to its plain version too. A mismatch raises (non-zero exit). Then device
time a call (utils/devicetime.py:marginal_block_time, `--trips C1,C2` fixes
its two trip counts) of K2 and of each arm on the same tiles: ms, K2 / arm,
ns a pair, the bound (ops/roofline.py: K2's, with K12's two flag words
added to its bytes; K15's eqb_only its own) and the share bound / time. pallas and wide also time
their kernel alone (no t outside it, no patch) beside the arm. sol gives
the attribution of the TPU probe: eqb_build = eqb_only, greedy_chain =
scan_only - eqb_only, a_compaction = no_tcount - scan_only,
b_compaction_and_t = full - no_tcount, each also as a share of full.

Writes chiprun_out/ab_torch_jaro.json (`--out`) with the card's name and
power limit (nvidia-smi); the last line of stdout is one JSON summary.
Without a CUDA device it exits non-zero unless --device cpu is given: 512
rows, one width a probe, the plain versions, and no times ("not measured").
Imports torch and strsim_tpu_torch only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import LADDER  # noqa: E402  (the bucket ladder)

PROBES = ("pallas", "wide", "wide2", "sol")
TPU_TOOLS = {"pallas": "tools/ab_jaro_pallas.py", "wide": "tools/ab_jaro_wide.py",
             "wide2": "tools/ab_jaro_wide2.py", "sol": "tools/ab_jaro_sol_probe.py"}
# (width, dtype, lengths) of each probe's cases, in the TPU tools' order
CASES = {
    "pallas": [(w, d, "uniform") for w in (7, 15, 31) for d in ("int8", "int32")],
    "wide": [(w, "int8", "uniform") for w in (95, 127, 255, 511)],
    "wide2": [(w, d, "wide2") for w in (191, 383, 511) for d in ("int8", "int32")],
    "sol": [(15, "int8", "sol"), (31, "int8", "sol"), (63, "int8", "wide2"),
            (255, "int8", "wide2"), (511, "int8", "wide2"), (511, "int32", "wide2")],
}
# --ladder: sol at every width of the bucket ladder on both dtypes
LADDER_SOL = [(w, d, "sol" if w <= 31 else "wide2") for w in LADDER for d in ("int8", "int32")]
QUICK = {"pallas": 15, "wide": 255, "wide2": 383, "sol": 31}
SEEDS = {"pallas": 0, "wide": 0, "wide2": 23, "sol": 7}
ROWS = 65536
CPU_ROWS = 512
TPU_ROWS = {"pallas": 262144, "wide": 65536, "wide2": 65536, "sol": 262144}
NOT_MEASURED = "not measured"


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--probes", default=",".join(PROBES))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--trips", default=None, help="C1,C2: marginal_block_time's two trip counts")
    p.add_argument("--ladder", action="store_true",
                   help="sol at every ladder width on int8 and int32, with K2's residency")
    p.add_argument("--out", default=str(REPO / "chiprun_out" / "ab_torch_jaro.json"))
    args = p.parse_args(argv)
    args.probes = args.probes.split(",")
    unknown = sorted(set(args.probes) - set(PROBES))
    if unknown:
        p.error(f"unknown probes {unknown}; choose from {PROBES}")
    if args.device == "cpu":
        args.quick = True
    args.rows = CPU_ROWS if args.device == "cpu" else ROWS
    return args


def make_inputs(rng, rows: int, width: int, lengths: str):
    """([rows, 2 * width] codes, [2, rows] int32 lengths) from the TPU tools'
    generators, padded past the lengths with -1 (a) and -2 (b)."""
    codes = rng.integers(97, 123, size=(rows, 2 * width))
    if lengths == "uniform":  # ab_jaro_pallas.py:150, ab_jaro_wide.py:151
        lens = rng.integers(1, width + 1, size=(rows, 2))
    elif lengths == "wide2":  # ab_jaro_wide2.py:221-227
        lens = np.empty((rows, 2), np.int64)
        lens[:, 0] = rng.integers((3 * width) // 4, width + 1, size=rows)
        lens[:, 1] = rng.integers(2, width + 1, size=rows)
        swap = rng.random(rows) < 0.5
        lens[swap] = lens[swap][:, ::-1]
    else:  # "sol": ab_jaro_sol_probe.py:190-194
        lens = rng.integers(max(2, width - 7), width + 1, size=(rows, 2))
    pos = np.arange(width)[None, :]
    codes[:, :width][pos >= lens[:, :1]] = -1
    codes[:, width:][pos >= lens[:, 1:]] = -2
    return codes, np.ascontiguousarray(lens.T).astype(np.int32)


class Timer:
    """Device ms a call of fn(*tiles), or "not measured" off the card."""

    def __init__(self, on_card: bool, trips, clock_hz: float):
        self.on_card, self.trips, self.clock_hz = on_card, trips, clock_hz

    def __call__(self, fn, tiles):
        if not self.on_card:
            return NOT_MEASURED
        from strsim_tpu_torch.utils.devicetime import marginal_block_time

        kw = {"clock_hz": self.clock_hz}
        if self.trips:
            kw.update(c1=self.trips[0], c2=self.trips[1], min_delta_ms=0.0)
        return marginal_block_time(fn, [tiles], **kw)


def _check_equal(label, got, want, lens):
    import torch

    for name, g, w in zip(("m", "t"), got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            bad = int(torch.nonzero(g != w)[0][0]) if g.shape == w.shape else -1
            raise AssertionError(f"{label}: {name} differs from its reference at row {bad} "
                                 f"(la={int(lens[0, bad])}, lb={int(lens[1, bad])}): "
                                 f"{int(g[bad])} against {int(w[bad])}")


def _arm(ms, k2_ms, rows, bound_ms):
    if ms == NOT_MEASURED:
        return {"ms": ms}
    return {"ms": ms, "k2_over_arm": k2_ms / ms, "ns_pair": ms * 1e6 / rows,
            "bound_ms": bound_ms, "share": bound_ms / ms}


def run_case(probe, width, dtype, lengths, rng, args, device, timer, clock_hz) -> dict:
    """One probe at one width and dtype: parity against K2 (and each K15
    mode against its plain version), then the times."""
    import torch

    from strsim_tpu_torch.ops import jaro_cuda
    from strsim_tpu_torch.ops.jaro_cuda import patch_one_one
    from strsim_tpu_torch.ops.roofline import bound
    from strsim_tpu_torch.probes import jaro as probes

    codes, lens = make_inputs(rng, args.rows, width, lengths)
    c = torch.from_numpy(codes.astype(np.int8 if dtype == "int8" else np.int32)).to(device)
    lt = torch.from_numpy(lens).to(device)
    tiles = (c[:, :width], c[:, width:], lt[0], lt[1])
    label = f"{probe} w{width} {dtype}"
    k2 = jaro_cuda.jaro_match_stats(*tiles)

    def patched(fn):
        return lambda *t: patch_one_one(*t, *fn(*t))

    arms, arm_flags = {}, {}  # name -> the callable timed, its flags for the bound
    kernel = {"pallas": "jaro_flags_probe", "wide": "jaro_packed_t", "wide2": "jaro_clipped",
              "sol": "jaro_ablated"}[probe]
    if probe == "pallas":
        _check_equal(label, probes.jaro_flags_probe(*tiles), k2, lens)
        arms = {"probe": probes.jaro_flags_probe, "kernel": probes.jaro_flags_scan}
    elif probe == "wide":
        _check_equal(label, probes.jaro_packed_t(*tiles), k2, lens)
        arms = {"probe": probes.jaro_packed_t, "kernel": probes.packed_t_stats}
    elif probe == "wide2":
        for clip in probes.CLIPS:
            fn = lambda *t, clip=clip: probes.jaro_clipped(*t, clip=clip)  # noqa: E731
            _check_equal(f"{label} clip={clip}", patched(fn)(*tiles), k2, lens)
            arms[f"clip_{clip}"] = fn
    else:
        for mode in probes.MODES:
            fn = lambda *t, mode=mode: probes.jaro_ablated(*t, mode=mode)  # noqa: E731
            got = fn(*tiles)
            _check_equal(f"{label} {mode}", got, probes.jaro_ablated_plain(*tiles, mode=mode), lens)
            if mode == "full":
                _check_equal(f"{label} full, patched", patched(fn)(*tiles), k2, lens)
            arms[mode], arm_flags[mode] = fn, {"mode": mode}
    out_bytes = 12 if probe == "pallas" else 8  # K12: m and its two flag words
    elem = 1 if dtype == "int8" else 4

    def arm_bound(flags):
        if not timer.on_card:
            return NOT_MEASURED, NOT_MEASURED
        return bound(kernel, flags, lens, elem, out_bytes, clock_hz)

    b_ms, b_by = arm_bound({})
    k2_b_ms = bound("jaro_scan", {}, lens, elem, 8, clock_hz)[0] if timer.on_card else NOT_MEASURED
    k2_ms = timer(jaro_cuda.jaro_match_stats, tiles)
    rec = {"probe": probe, "tpu_tool": TPU_TOOLS[probe], "kernel": kernel, "width": width,
           "dtype": dtype, "lengths": lengths, "rows": args.rows, "parity": "exact",
           "bound_ms": b_ms, "bound_by": b_by, "k2": _arm(k2_ms, k2_ms, args.rows, k2_b_ms),
           "arms": {name: _arm(timer(fn, tiles), k2_ms, args.rows,
                               arm_bound(arm_flags.get(name, {}))[0])
                    for name, fn in arms.items()}}
    if timer.on_card:
        rec["k2"]["residency"] = jaro_cuda.residency(width, c.dtype)
    if probe == "sol" and timer.on_card:
        ms = {mode: rec["arms"][mode]["ms"] for mode in probes.MODES}
        parts = {"eqb_build": ms["eqb_only"], "greedy_chain": ms["scan_only"] - ms["eqb_only"],
                 "a_compaction": ms["no_tcount"] - ms["scan_only"],
                 "b_compaction_and_t": ms["full"] - ms["no_tcount"]}
        rec["attribution_ms"] = parts
        rec["attribution_share_of_full"] = {k: v / ms["full"] for k, v in parts.items()}
    return rec


def _line(rec) -> str:
    def f(x):
        return x if isinstance(x, str) else f"{x:.4f}"

    arms = ", ".join(f"{k} {f(v['ms'])} ms" + (f" (K2/arm {v['k2_over_arm']:.3f})"
                                               if "k2_over_arm" in v else "")
                     for k, v in rec["arms"].items())
    out = (f"  {rec['probe']:6s} w{rec['width']:<3d} {rec['dtype']:5s} exact; K2 {f(rec['k2']['ms'])} "
           f"ms; {arms}; bound {f(rec['bound_ms'])} ms")
    if "residency" in rec["k2"]:
        out += "; K2 " + ", ".join(f"{k} {v}" for k, v in rec["k2"]["residency"].items())
    if "attribution_share_of_full" in rec:
        out += "; of full: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         rec["attribution_share_of_full"].items())
    return out


def main(argv) -> int:
    args = _parse(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ab_torch_jaro: no CUDA device (pass --device cpu for the CPU smoke)", file=sys.stderr)
        return 2
    from strsim_tpu_torch.ops.roofline import card_line, max_sm_clock_hz

    on_card = args.device == "cuda"
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    card = card_line() if on_card else "cpu"
    clock_hz = max_sm_clock_hz() if on_card else 0.0
    trips = tuple(int(x) for x in args.trips.split(",")) if args.trips else None
    timer = Timer(on_card, trips, clock_hz)
    t0 = time.perf_counter()
    print(f"ab_torch_jaro: {card}, {args.rows} rows a block, probes {','.join(args.probes)}",
          flush=True)
    records = []
    for probe in args.probes:
        rng = None
        for width, dtype, lengths in (LADDER_SOL if args.ladder and probe == "sol" else CASES[probe]):
            if args.quick and width != QUICK[probe]:
                continue
            if rng is None or probe in ("pallas", "wide"):  # a fresh seed a width there
                rng = np.random.default_rng(SEEDS[probe])
            rec = run_case(probe, width, dtype, lengths, rng, args, device, timer, clock_hz)
            records.append(rec)
            print(_line(rec), flush=True)
    reduced = sorted({f"{p}: {args.rows} rows a block (TPU run {TPU_ROWS[p]})"
                      for p in args.probes if args.rows != TPU_ROWS[p]})
    if args.quick:
        reduced.append("one width a probe: " + ", ".join(f"{p} w{QUICK[p]}" for p in args.probes))
    details = {"device": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "rows": args.rows, "trips": trips, "reduced": reduced, "cases": records,
               "wall_s": time.perf_counter() - t0}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(details, indent=1))
    summary = {"tool": "ab_torch_jaro", "device": card, "rows": args.rows, "cases": len(records),
               "parity": "exact", "out": os.path.relpath(out, REPO) if out.is_absolute() else str(out),
               "k2_over_arm": {f"{r['probe']} w{r['width']} {r['dtype']} {k}": v.get("k2_over_arm",
                                                                                      NOT_MEASURED)
                               for r in records for k, v in r["arms"].items()}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
