"""The one general traffic generator: a cell's inputs from its configuration
(`configs/<config>.json`: the deployment, its column generator and the
generator's parameters) and its traffic mix (`traffic/<traffic>.json`: the
call shape, the measures, the sizes), both found by the names in
BENCHMARK.json, and from the run's seed. The call shape
(`shapes/<shape>.py`, named by the traffic's "shape") turns the generator's
columns into the calls' inputs.

A seed gives the same inputs every time. `scale` shrinks the sizes for a rehearsal on the CPU.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import List

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
class Workload:
    name: str
    config: dict
    traffic: dict
    measures: tuple
    shape: object             # the module shapes/<shape>.py
    inputs: List[object]      # the shape's inputs, one a call


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def scaled(n: int, scale: float, least: int) -> int:
    return max(least, int(round(n * scale)))


def load(bench: dict, name: str, seed: int, scale: float = 1.0) -> Workload:
    """The cell `name` of the manifest `bench`, with its inputs made from
    `seed`."""
    w = cell(bench, name)
    config = read_json(HERE / "configs" / f"{w['config']}.json")
    traffic = read_json(HERE / "traffic" / f"{w['traffic']}.json")
    gen = importlib.import_module(f"perfbench.generators.{config['generator']}").generate
    shape = importlib.import_module(f"perfbench.shapes.{traffic['shape']}")
    inputs = shape.inputs(gen, config["params"], traffic, seed, scale)
    return Workload(name=name, config=config, traffic=traffic,
                    measures=tuple(traffic["measures"]), shape=shape, inputs=inputs)
