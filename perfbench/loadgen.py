"""The one general traffic generator: a cell's inputs from its configuration
(`configs/<config>.json`: the deployment, its column generator and the
generator's parameters) and its traffic mix (`traffic/<traffic>.json`: the
call shape, the measures, the sizes), both found by the names in
BENCHMARK.json, and from the run's seed.

Call shapes:
  "pairs"         `batches` pairs of columns of `pairs_per_call` rows each,
                  made by the generator; the window's calls alternate them.

A seed gives the same inputs every time. `scale` shrinks the sizes for a rehearsal on the CPU.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def child_seed(seed: int, *tags: int) -> int:
    """A 64-bit seed for one stream of the run's randomness."""
    state = np.random.SeedSequence([seed & (2**64 - 1), *tags]).generate_state(1, np.uint64)
    return int(state[0])


@dataclasses.dataclass
class Input:
    """One call's input: columns a and b, lists of str | None as a Polars
    column's to_list() gives them."""

    a: list
    b: list
    check_rows: Optional[np.ndarray] = None  # rows whose scores the check compares
    _device: Optional[tuple] = None

    @property
    def rows(self) -> int:
        return len(self.b)

    def device_rows(self):
        """(la, lb, ascii) of the rows that need kernel math: both sides
        non-null, not equal, neither empty (the reference's conventions
        decide the others without any)."""
        if self._device is None:
            la, lb, asc = [], [], []
            for x, y in zip(self.a, self.b):
                if x is None or y is None or x == y or not x or not y:
                    continue
                la.append(len(x))
                lb.append(len(y))
                asc.append(x.isascii() and y.isascii())
            self._device = (np.array(la, dtype=np.int64), np.array(lb, dtype=np.int64),
                            np.array(asc, dtype=bool))
        return self._device


@dataclasses.dataclass
class Workload:
    name: str
    config: dict
    traffic: dict
    measures: tuple
    inputs: List[Input]


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _scaled(n: int, scale: float, least: int) -> int:
    return max(least, int(round(n * scale)))


def _pairs(gen, params, traffic, seed, scale):
    n = _scaled(traffic["pairs_per_call"], scale, 64)
    inputs = []
    for k in range(traffic["batches"]):
        a, b = gen(n, child_seed(seed, 1, k), **params)
        inputs.append(Input(a=a.tolist(), b=b.tolist()))
    return inputs


SHAPES = {"pairs": _pairs}


def load(bench: dict, name: str, seed: int, scale: float = 1.0) -> Workload:
    """The cell `name` of the manifest `bench`, with its inputs made from
    `seed`."""
    w = cell(bench, name)
    config = read_json(HERE / "configs" / f"{w['config']}.json")
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    gen = importlib.import_module(f"perfbench.generators.{config['generator']}").generate
    inputs = SHAPES[traffic["shape"]](gen, config["params"], traffic, seed, scale)
    return Workload(name=name, config=config, traffic=traffic,
                    measures=tuple(traffic["measures"]), inputs=inputs)
