#!/usr/bin/env python3
"""A/B of the Myers and fused lev + jaro probes K16-K19 against the
production kernels they question (K1, K2, K5) on one CUDA GPU: the port of
tools/ab_myers_pallas.py, ab_myers_swar.py and ab_fused_lj.py.

    python3 tools/ab_torch_myers.py                            # all three, full size
    python3 tools/ab_torch_myers.py --probes swar,fused_lj     # some of them
    python3 tools/ab_torch_myers.py --quick --trips 2,6        # one width a probe
    python3 tools/ab_torch_myers.py --device cpu               # flow smoke on the CPU

Probes, named after the TPU tools they port (`strsim_tpu_torch/probes/myers.py`):
  pallas    K16 over equality words built outside it, its scan (a runtime
            trip count) and its unrolled steps, each timed alone and as an
            arm with `pattern_eq_words` in torch in front of it, and K17,
            the words built in the kernel by 32 compares; w7, w15, w31 (the
            tool's widths) and w32 (the one-word edge), on int8 and on int32
            tiles of the same codes; lengths uniform in 1..w, chars 97..122,
            seed 0 a width (ab_myers_pallas.py:make_inputs);
  swar      K18, the words built four pattern bytes a compare; w7, w15, w31,
            int8; the same generator (ab_myers_swar.py:make_inputs);
  fused_lj  K19, jaro's equality words transposed into Myers's; L = 15 and
            31, int8; lengths in 2..L, the first eighth of the rows in 2..4,
            chars 97..122, one seed-11 generator over the widths in turn
            (ab_fused_lj.py:main).
Every generator pads past the lengths (-1 / -2) as the port's encoder does
(ab_fused_lj.py leaves its codes unpadded; no output depends on them).
Rows: 262,144 a block, the TPU tools' own BLOCK. `--quick`: one width a
probe (pallas w15, swar w15, fused_lj L = 31).

Per case, on tiles staged on the card: parity first. Each probe's output
equals its plain version on every row; K16-K18 equal K1
(ops/levenshtein_cuda.py:levenshtein_distance) on every row whose lengths
are both >= 1; K19's lev equals K1's, its (m, t) after
ops/jaro_cuda.py:patch_one_one K2's, and its (lev, m, t) after the patch
K5's (ops/lev_jaro_cuda.py:lev_jaro_stats, without inter). A mismatch
raises (non-zero exit). Then the device time of a call
(utils/devicetime.py:marginal_block_time, `--trips C1,C2` fixes its two
trip counts) of each baseline and each arm on the same tiles: ms, baseline
/ arm, ns a pair, the bound (ops/roofline.py) and the share bound / time.
Baselines: K1 for pallas and swar; for fused_lj K1 + K2 ("separate", the TPU
tool's baseline, one call running both), K1 and K2 alone, and K5.

Writes chiprun_out/ab_torch_myers.json (`--out`) with the card's name and
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

PROBES = ("pallas", "swar", "fused_lj")
TPU_TOOLS = {"pallas": "tools/ab_myers_pallas.py", "swar": "tools/ab_myers_swar.py",
             "fused_lj": "tools/ab_fused_lj.py"}
# (width, dtype) of each probe's cases, in the TPU tools' order
CASES = {
    "pallas": [(w, d) for w in (7, 15, 31, 32) for d in ("int8", "int32")],
    "swar": [(w, "int8") for w in (7, 15, 31)],
    "fused_lj": [(15, "int8"), (31, "int8")],
}
QUICK = {"pallas": 15, "swar": 15, "fused_lj": 31}
SEEDS = {"pallas": 0, "swar": 0, "fused_lj": 11}
ROWS = 262144
CPU_ROWS = 512
NOT_MEASURED = "not measured"


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--probes", default=",".join(PROBES))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--trips", default=None, help="C1,C2: marginal_block_time's two trip counts")
    p.add_argument("--out", default=str(REPO / "chiprun_out" / "ab_torch_myers.json"))
    args = p.parse_args(argv)
    args.probes = args.probes.split(",")
    unknown = sorted(set(args.probes) - set(PROBES))
    if unknown:
        p.error(f"unknown probes {unknown}; choose from {PROBES}")
    if args.device == "cpu":
        args.quick = True
    args.rows = CPU_ROWS if args.device == "cpu" else ROWS
    return args


def make_inputs(rng, rows: int, width: int, probe: str):
    """([rows, 2 * width] codes, [2, rows] int32 lengths) from the TPU
    tools' generators, padded past the lengths with -1 (a) and -2 (b)."""
    if probe == "fused_lj":  # ab_fused_lj.py:238-241
        codes = rng.integers(97, 123, size=(rows, 2 * width))
        lens = rng.integers(2, width + 1, size=(rows, 2))
        lens[: rows // 8] = rng.integers(2, 5, size=(rows // 8, 2))
    else:  # ab_myers_pallas.py:207-214, ab_myers_swar.py:144-151 (int32 draws)
        codes = rng.integers(97, 123, size=(rows, 2 * width), dtype=np.int32)
        lens = rng.integers(1, width + 1, size=(rows, 2), dtype=np.int32)
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


def _check_equal(label, names, got, want, lens, rows=None):
    """got[k] == want[k] on every row (or on the rows of the bool mask
    `rows`); raises at the first row that differs."""
    import torch

    for name, g, w in zip(names, got, want):
        if rows is not None:
            g, w = torch.where(rows, g, 0), torch.where(rows, w, 0)
        if g.shape != w.shape or not torch.equal(g, w):
            bad = int(torch.nonzero(g != w)[0][0]) if g.shape == w.shape else -1
            raise AssertionError(f"{label}: {name} differs from its reference at row {bad} "
                                 f"(la={int(lens[0, bad])}, lb={int(lens[1, bad])}): "
                                 f"{int(g[bad])} against {int(w[bad])}")


def _entry(ms, rows, bound_ms, baselines=None):
    if ms == NOT_MEASURED:
        return {"ms": ms}
    rec = {"ms": ms, "ns_pair": ms * 1e6 / rows, "bound_ms": bound_ms, "share": bound_ms / ms}
    for name, base in (baselines or {}).items():
        rec[f"{name}_over_arm"] = base / ms
    return rec


def run_case(probe, width, dtype, rng, args, device, timer, clock_hz) -> dict:
    """One probe at one width and dtype: parity, then the times."""
    import torch

    from strsim_tpu_torch.ops import jaro_cuda, lev_jaro_cuda, levenshtein_cuda
    from strsim_tpu_torch.ops.roofline import bound
    from strsim_tpu_torch.probes import myers as probes

    codes, lens = make_inputs(rng, args.rows, width, probe)
    c = torch.from_numpy(codes.astype(np.int8 if dtype == "int8" else np.int32)).to(device)
    lt = torch.from_numpy(lens).to(device)
    tiles = (c[:, :width], c[:, width:], lt[0], lt[1])
    a, b, la, lb = tiles
    label = f"{probe} w{width} {dtype}"
    elem = 1 if dtype == "int8" else 4
    k1 = levenshtein_cuda.levenshtein_distance(*tiles)
    both = (la >= 1) & (lb >= 1)

    # name -> (the callable timed, its kernel for the bound, its output bytes a row)
    if probe == "fused_lj":
        got = probes.fused_lev_jaro(*tiles)
        _check_equal(label, ("lev", "m", "t"), got, probes.fused_lev_jaro_plain(*tiles), lens)
        patched = jaro_cuda.patch_one_one(*tiles, got[1], got[2])
        _check_equal(f"{label} vs K1, K2", ("lev", "m", "t"), (got[0], *patched),
                     (k1, *jaro_cuda.jaro_match_stats(*tiles)), lens)
        _check_equal(f"{label} vs K5", ("lev", "m", "t"), (got[0], *patched),
                     lev_jaro_cuda.lev_jaro_stats(*tiles)[:3], lens)

        def separate(*t):
            return levenshtein_cuda.levenshtein_distance(*t), jaro_cuda.jaro_match_stats(*t)

        baselines = {"separate": (separate, None, 0), "k1": (levenshtein_cuda.levenshtein_distance,
                                                             "levenshtein_myers", 4),
                     "k2": (jaro_cuda.jaro_match_stats, "jaro_scan", 8),
                     "k5": (lev_jaro_cuda.lev_jaro_stats, "lev_jaro_fused", 16)}
        arms = {"fused": (probes.fused_lev_jaro, "fused_lev_jaro", 12)}
        versus = ("separate", "k5")
    else:
        eq = probes.pattern_eq_words(a, b)
        arms = {}
        if probe == "pallas":
            for unroll, name in ((False, "scan"), (True, "unroll")):
                fn = lambda *t, u=unroll: probes.myers_eq_scan(eq, t[2], t[3], u)  # noqa: E731
                arm = lambda *t, u=unroll: probes.myers_eq_arm(*t, unroll=u)  # noqa: E731
                _check_equal(f"{label} {name}", ("lev",), (fn(*tiles),),
                             (probes.myers_eq_scan_plain(eq, la, lb, unroll),), lens)
                _check_equal(f"{label} {name}+build", ("lev",), (arm(*tiles),), (k1,), lens, both)
                arms[name] = (fn, "myers_eq_scan", 4)
                arms[f"{name}_with_build"] = (arm, "levenshtein_myers", 4)
            arms["ineq"] = (probes.myers_ineq, "myers_ineq", 4)
            plain = probes.myers_ineq_plain
        else:
            arms["swar"] = (probes.myers_swar, "myers_swar", 4)
            plain = probes.myers_swar_plain
        fn = arms["ineq" if probe == "pallas" else "swar"][0]
        got = fn(*tiles)
        _check_equal(label, ("lev",), (got,), (plain(*tiles),), lens)
        _check_equal(f"{label} vs K1", ("lev",), (got,), (k1,), lens, both)
        baselines = {"k1": (levenshtein_cuda.levenshtein_distance, "levenshtein_myers", 4)}
        versus = ("k1",)

    def bound_of(kernel, out_bytes):
        """(ms, "bytes" or "operations") of the kernel's function here."""
        if not timer.on_card:
            return NOT_MEASURED, NOT_MEASURED
        if kernel is None:  # "separate": K1's bound and K2's
            (ms1, by1), (ms2, by2) = (bound("levenshtein_myers", {}, lens, elem, 4, clock_hz),
                                      bound("jaro_scan", {}, lens, elem, 8, clock_hz))
            return ms1 + ms2, by1 if ms1 >= ms2 else by2
        return bound(kernel, {}, lens, elem, out_bytes, clock_hz)

    base_ms = {name: timer(fn, tiles) for name, (fn, _, _) in baselines.items()}
    _, kernel, out = next(iter(arms.values()))  # the probe's own kernel
    b_ms, b_by = bound_of(kernel, out)
    rec = {"probe": probe, "tpu_tool": TPU_TOOLS[probe], "width": width, "dtype": dtype,
           "rows": args.rows, "parity": "exact", "bound_ms": b_ms, "bound_by": b_by,
           "baselines": {name: _entry(base_ms[name], args.rows, bound_of(kernel, out)[0])
                         for name, (_, kernel, out) in baselines.items()},
           "arms": {}}
    for name, (fn, kernel, out) in arms.items():
        vs = {k: base_ms[k] for k in versus} if timer.on_card else None
        rec["arms"][name] = _entry(timer(fn, tiles), args.rows, bound_of(kernel, out)[0], vs)
    return rec


def _line(rec) -> str:
    def f(x):
        return x if isinstance(x, str) else f"{x:.4f}"

    base = ", ".join(f"{k} {f(v['ms'])}" for k, v in rec["baselines"].items())
    arms = "; ".join(f"{k} {f(v['ms'])} ms" + "".join(
        f" ({r[:-len('_over_arm')]}/arm {x:.3f})" for r, x in v.items() if r.endswith("_over_arm"))
        for k, v in rec["arms"].items())
    return (f"  {rec['probe']:8s} w{rec['width']:<3d} {rec['dtype']:5s} exact; {base} ms; {arms}; "
            f"bound {f(rec['bound_ms'])} ms")


def main(argv) -> int:
    args = _parse(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ab_torch_myers: no CUDA device (pass --device cpu for the CPU smoke)", file=sys.stderr)
        return 2
    from strsim_tpu_torch.ops.roofline import card_line, max_sm_clock_hz

    on_card = args.device == "cuda"
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    card = card_line() if on_card else "cpu"
    clock_hz = max_sm_clock_hz() if on_card else 0.0
    trips = tuple(int(x) for x in args.trips.split(",")) if args.trips else None
    timer = Timer(on_card, trips, clock_hz)
    t0 = time.perf_counter()
    print(f"ab_torch_myers: {card}, {args.rows} rows a block, probes {','.join(args.probes)}",
          flush=True)
    records = []
    for probe in args.probes:
        rng = np.random.default_rng(SEEDS[probe])
        for width, dtype in CASES[probe]:
            if probe != "fused_lj":  # make_inputs(width, seed=0): a fresh seed a width
                rng = np.random.default_rng(SEEDS[probe])
            if args.quick and width != QUICK[probe]:
                continue
            rec = run_case(probe, width, dtype, rng, args, device, timer, clock_hz)
            records.append(rec)
            print(_line(rec), flush=True)
    reduced = []
    if args.rows != ROWS:
        reduced.append(f"{args.rows} rows a block (TPU run {ROWS})")
    if args.quick:
        reduced.append("one width a probe: " + ", ".join(f"{p} w{QUICK[p]}" for p in args.probes))
    details = {"device": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "rows": args.rows, "trips": trips, "reduced": reduced, "cases": records,
               "wall_s": time.perf_counter() - t0}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(details, indent=1))
    ratios = {}  # "<case> <arm> vs <baseline>": baseline ms / arm ms
    for r in records:
        for arm, v in r["arms"].items():
            over = {k[:-len("_over_arm")]: x for k, x in v.items() if k.endswith("_over_arm")}
            for base, x in (over or {"baseline": NOT_MEASURED}).items():
                ratios[f"{r['probe']} w{r['width']} {r['dtype']} {arm} vs {base}"] = x
    summary = {"tool": "ab_torch_myers", "device": card, "rows": args.rows, "cases": len(records),
               "parity": "exact", "out": os.path.relpath(out, REPO) if out.is_absolute() else str(out),
               "baseline_over_arm": ratios}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
