"""K11: the toolchain's first build and launch, timed (csrc/warm.cu).

`warm(x)` launches the CUDA kernel, `out = x * 2 + 1` over an int32 tensor
on the card; `warm_plain` is the same function in plain torch. The
counterpart of bench.py's `k` (bench.py:685), a Pallas kernel of the same
body that bench.py ran once on an [8, 128] int32 tile to pay the TPU
compiler's first initialisation. bench_torch.py launches it once after the
kernels' build and reports that launch's time; chip_smoke.py holds it to
`warm_plain`. It has no CPU role: on a CPU tensor it raises.
"""
from __future__ import annotations

import torch

from strsim_tpu_torch.ops import _build


def warm(x: torch.Tensor) -> torch.Tensor:
    """x * 2 + 1 (int32, wrapping) by the CUDA kernel; x: contiguous int32
    on a CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"warm launches the CUDA kernel K11 and takes CUDA tensors only; "
                         f"x lies on {x.device}")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous int32, got {x.dtype} strides {x.stride()}")
    out = torch.empty_like(x)
    _build.call("warm", "strsim_warm", ("warm",), x.device,
                x.data_ptr(), out.data_ptr(), x.numel())
    return out


def warm_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2 + 1
