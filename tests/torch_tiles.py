"""Shared tile generator and converters for the strsim_tpu_torch tests: the
same numpy-seeded tiles go through strsim_tpu (as jax arrays) and
strsim_tpu_torch (as CPU tensors)."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

# The tensors here are small: torch's intra-op thread pool only spins idle
# threads that contend with the other test workers for the cores.
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import LADDER, make_tiles as make_packed_tiles  # noqa: E402


def make_tiles(seed: int, n: int, width: int, dtype):
    """[n, width] a/b tiles padded with -1/-2 and [n] int32 lengths, split
    from chip_smoke.make_tiles's packed tile (see there for the row mix)."""
    packed, lens = make_packed_tiles(np.random.default_rng(seed), n, width, dtype)
    return (np.ascontiguousarray(packed[:, :width]), np.ascontiguousarray(packed[:, width:]),
            lens[0].copy(), lens[1].copy())


def as_torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in arrays)


def as_jax(*arrays):
    return tuple(jnp.asarray(x) for x in arrays)


def assert_same(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
