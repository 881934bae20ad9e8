"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each `csrc/*.cu` file compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <BUILD_DIR>/<name>-<hash>.so <name>.cu

BUILD_DIR is build/strsim_tpu_torch/ in a source checkout (see `_build_dir`).

The file name carries a hash of the source and the flags, so an edited kernel
never loads a stale build. Nothing builds at import time: a wrapper's first
launch calls `library()`, and `build_all()` starts every nvcc at once.

The wrappers launch through `launch`, which counts each launch under the
kernel's name, so a run can show that its main path went through each
kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> Path:
    """$STRSIM_TPU_TORCH_BUILD_DIR if set; else build/strsim_tpu_torch/ at the
    root of the source checkout that holds this package; else (an installed
    package) strsim_tpu_torch/ under the user's cache directory."""
    override = os.environ.get("STRSIM_TPU_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "strsim_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "strsim_tpu_torch"


BUILD_DIR = _build_dir()

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the build log
)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# library name -> (source file, {C function: argtypes}); every function
# returns the launch's cudaError_t as an int.
LIBRARIES: Dict[str, Tuple[str, Dict[str, list]]] = {
    "levenshtein_myers": (
        "levenshtein_myers.cu",
        {"strsim_levenshtein_myers": [_P, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _P]},
    ),
    "jaro_scan": (
        "jaro_scan.cu",
        {"strsim_jaro_scan": [_P, _P, _LL, _LL, _P, _P, _P, _P, _I, _I, _I, _P]},
    ),
    "multiset": (
        "multiset.cu",
        {
            "strsim_multiset_rank": [_P, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _P],
            "strsim_multiset_hist": [_P, _P, _LL, _LL, _P, _P, _P, _I, _I, _P],
        },
    ),
    "lev_jaro_fused": (
        "lev_jaro_fused.cu",
        {"strsim_lev_jaro_fused": [_P, _P, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _P]},
    ),
    "dp_fused": (
        "dp_fused.cu",
        {"strsim_dp_fused": [_P, _P, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    ),
    "osa_scan": (
        "osa_scan.cu",
        {"strsim_osa_distance": [_P, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _P]},
    ),
    "bigram": (
        "bigram.cu",
        {"strsim_bigram": [_P, _P, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    ),
    "jaro_flags": (
        "jaro_flags.cu",
        {"strsim_jaro_flags": [_P, _P, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    ),
    "levenshtein_wavefront": (
        "levenshtein_wavefront.cu",
        {"strsim_levenshtein_wavefront": [_P, _P, _LL, _LL, _P, _P, _P, _I, _I, _I, _P]},
    ),
    "warm": ("warm.cu", {"strsim_warm": [_P, _P, _LL, _P]}),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, every csrc/*.cuh
    header (a source may include any of them) and the flags."""
    h = hashlib.sha256((_CSRC / LIBRARIES[name][0]).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _compile(names: List[str]) -> Dict[str, Tuple[float, str]]:
    """Run one nvcc per missing library, all at once. Returns
    {name: (seconds, compiler log)} for the libraries it built."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / LIBRARIES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    built, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
        built[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return built


def build_all() -> Dict[str, Tuple[float, str]]:
    """Build every kernel library now (one nvcc per source, in parallel) and
    load it. Returns {name: (seconds, compiler log)} for those built here."""
    with _lock:
        built = _compile(list(LIBRARIES))
    for name in LIBRARIES:
        library(name)
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _compile([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in LIBRARIES[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check_tiles(a, b, len_a, len_b, max_width: int, dtypes) -> bool:
    """Validate one stat call's inputs; True when they lie on a CUDA device
    (launch the kernel), False on the CPU (run the plain version).

    a, b: [B, L] tiles of one of `dtypes` on one device, each row contiguous
    (stride(1) == 1) with any row stride >= L, so both may be column slices
    of the pipeline's packed [B, 2L] tile without a copy. len_a, len_b: [B]
    contiguous int32 on the same device.
    """
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"tiles must be [B, L] of one shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    n, width = a.shape
    if not 1 <= width <= max_width:
        raise ValueError(f"tile width {width} outside 1..{max_width}")
    if a.dtype not in dtypes or b.dtype != a.dtype:
        raise TypeError(f"tiles must be one of {dtypes}, got {a.dtype} and {b.dtype}")
    for name, t in (("a", a), ("b", b)):
        if n > 1 and (t.stride(1) != 1 or t.stride(0) < width):
            raise ValueError(f"tile {name} rows must be contiguous, got strides {t.stride()}")
    for name, t in (("len_a", len_a), ("len_b", len_b)):
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{n}], got {t.dtype} {tuple(t.shape)}")
    devices = {a.device, b.device, len_a.device, len_b.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    kind = a.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    return kind == "cuda"


def call(lib_name: str, fn_name: str, counts: Tuple[str, ...], device, *args) -> None:
    """Call C function `fn_name` of library `lib_name` as fn(*args, stream)
    on `device`'s current stream. Raises if it returned a CUDA error; adds
    one to each launch count in `counts` otherwise."""
    fn = getattr(library(lib_name), fn_name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {fn_name} failed to launch: cudaError_t {rc}")
    for key in counts:
        _launches[key] = _launches.get(key, 0) + 1


def launch(lib_name: str, fn_name: str, counts: Tuple[str, ...], a, b, len_a, len_b,
           outs, *args) -> None:
    """Launch a tile kernel as fn(a, b, stride_a, stride_b, len_a, len_b,
    *outs, n, L, *args, stream) through `call`, where a None in `outs`
    passes a null pointer (an output the kernel then leaves out). No rows:
    nothing to launch."""
    n, width = a.shape
    if n == 0:
        return
    call(lib_name, fn_name, counts, a.device, a.data_ptr(), b.data_ptr(), a.stride(0),
         b.stride(0), len_a.data_ptr(), len_b.data_ptr(),
         *(None if o is None else o.data_ptr() for o in outs), n, width, *args)


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()
