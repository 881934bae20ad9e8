"""Carry state across from the JAX engine.

The engine has no weights: its state is the configuration and the encoded
tiles. Both converters take plain dicts and numpy arrays, so a caller holding
`strsim_tpu` objects passes `dataclasses.asdict(config)` and the arrays of an
`EncodedColumn` without this package importing jax.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from strsim_tpu_torch.config import StrsimConfig
from strsim_tpu_torch.utils.encode import EncodedColumn

# strsim_tpu.StrsimConfig fields with no counterpart here: compile and
# execute deadlines, Pallas blocks, the device mesh and placement. The six
# kernel overrides, the native finalize, the host-row scorer (`fallback`)
# and the short-circuit size carry over.
DROPPED_FIELDS = frozenset({
    "pallas_block_rows", "compile_timeout_s", "execute_timeout_s", "batch_axis",
    "data_parallel_devices", "device",
})


def config_from_jax(fields: dict, device: str = "cuda") -> StrsimConfig:
    """A StrsimConfig from `dataclasses.asdict` of a strsim_tpu config. Fields
    this engine has carry over; TPU-only ones are dropped; an unknown field
    raises KeyError."""
    known = {f.name for f in dataclasses.fields(StrsimConfig)}
    kw = {}
    for name, value in fields.items():
        if name in DROPPED_FIELDS:
            continue
        if name not in known:
            raise KeyError(f"unknown strsim_tpu config field {name!r}")
        kw[name] = tuple(value) if name == "buckets" else value
    return StrsimConfig(device=device, **kw)


def encoded_from_numpy(codes, lengths, validity) -> EncodedColumn:
    """An EncodedColumn from numpy arrays: codes [N, L] int8 or int32 (PAD
    past each length), lengths [N] ints, validity [N] bools."""
    codes = np.asarray(codes)
    lengths = np.asarray(lengths)
    validity = np.asarray(validity)
    if codes.ndim != 2 or codes.dtype not in (np.int8, np.int32):
        raise ValueError(f"codes must be a 2-D int8 or int32 array, got {codes.dtype} {codes.shape}")
    n, width = codes.shape
    if lengths.shape != (n,) or validity.shape != (n,):
        raise ValueError(f"lengths and validity must have shape ({n},)")
    if n and (lengths.min() < 0 or lengths.max() > width):
        raise ValueError(f"lengths must lie in 0..{width}")
    return EncodedColumn(
        codes=np.ascontiguousarray(codes),
        lengths=lengths.astype(np.int32),
        validity=validity.astype(bool),
    )
