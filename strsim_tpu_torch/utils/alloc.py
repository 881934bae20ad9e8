"""Host buffers for the encode, the pack and the upload.

`fast_empty` is `np.empty` for large staging buffers without the slow path
of 4 KiB first-touch page faults: an anonymous mmap advised to huge pages
(faults 2 MiB at a time) and, unless the first writer is a threaded native
pass, populated in one madvise call. Small requests take `np.empty`, whose
malloc reuse is cheaper than an mmap. The counterpart of
`strsim_tpu/utils/alloc.py`.

`staging_empty` is the upload's buffer: page-locked (pinned) host memory when
the bucket goes to a CUDA device, so that `.to(device, non_blocking=True)`
copies by DMA without a pageable bounce and without blocking the host; a
plain `fast_empty` buffer for the CPU device, where `pin_memory` would raise
on a CPU-only torch and no copy happens.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import mmap
from typing import Tuple

import numpy as np
import torch

# Below this, np.empty (malloc arena reuse) is as fast and has less set-up.
_MMAP_THRESHOLD = 4 << 20
_MADV_POPULATE_WRITE = 23  # Linux 5.14+; not exposed by the mmap module

_TORCH_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.int32): torch.int32}

_libc = None


def _madvise():
    global _libc
    if _libc is None:
        try:
            _libc = ctypes.CDLL("libc.so.6", use_errno=True)
            _libc.madvise.restype = ctypes.c_int
            _libc.madvise.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int)
        except OSError:  # not glibc: populate by first touch instead
            _libc = False
    return _libc.madvise if _libc else None


def fast_empty(shape, dtype, populate: bool = True) -> np.ndarray:
    """np.empty without 4 KiB first-touch faults on large buffers.

    populate=False leaves the faults to the first writer: use it when a
    threaded native pass fills the whole buffer at once (its threads fault
    huge pages in parallel). The mapping lives as long as the array."""
    dtype = np.dtype(dtype)
    shape = (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(shape)
    count = math.prod(shape)
    nbytes = count * dtype.itemsize
    if nbytes < _MMAP_THRESHOLD:
        return np.empty(shape, dtype)
    m = mmap.mmap(-1, nbytes)
    with contextlib.suppress(OSError):  # transparent huge pages off: 4 KiB pages
        m.madvise(mmap.MADV_HUGEPAGE)
    madvise = _madvise() if populate else None
    if madvise is not None:
        view = ctypes.c_char.from_buffer(m)
        madvise(ctypes.addressof(view), nbytes, _MADV_POPULATE_WRITE)  # best effort
        del view  # release the exported buffer so numpy can own the mapping
    return np.frombuffer(m, dtype=dtype, count=count).reshape(shape)


def staging_empty(shape, dtype, device: torch.device) -> Tuple[torch.Tensor, np.ndarray]:
    """(host tensor, its numpy view) of `shape` and numpy `dtype` to fill and
    upload to `device`: pinned for a CUDA device, else a `fast_empty`
    buffer. The caller keeps the tensor alive until every non-blocking copy
    from it has completed."""
    if device.type == "cuda":
        host = torch.empty(tuple(shape), dtype=_TORCH_DTYPES[np.dtype(dtype)], pin_memory=True)
        return host, host.numpy()
    buf = fast_empty(shape, dtype, populate=False)
    return torch.from_numpy(buf), buf
