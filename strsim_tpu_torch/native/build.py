"""Build the native host library with g++ at first use and load it.

    g++ -O3 -march=native -std=c++17 -shared -fPIC -pthread \
        -ffp-contract=off -DNDEBUG [-I<Python include>] strsim_host.cpp

The library goes into the kernels' build directory (`ops/_build.py`,
build/strsim_tpu_torch/ in a source checkout) under a hash of the source, the
flags and what `-march=native` selects on this machine, so an edited source
never loads a stale build and a library built for another machine is never
found. The compiler writes to
a name of its own process and thread and the result is renamed into place, so
processes that build at once into one directory each load a whole library.
A failed build raises with the compiler's output; nothing falls back.

Two handles on one library: `get_lib()` (ctypes.CDLL, the GIL released
around each call) for the array routes, and `get_pylib()` (ctypes.PyDLL, the
GIL held) for the routes that read CPython objects in place.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "strsim_host.cpp"

CXXFLAGS = (
    "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread",
    # bit-for-bit parity with the reference needs strict IEEE operations: no
    # FMA contraction (x*y+z fused changes the last ulp of jaro_winkler)
    "-ffp-contract=off",
    # the CPython-object routes must compile to plain struct reads: NDEBUG
    # drops the assert() calls inside the inline unicode accessors
    "-DNDEBUG",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_pylib: Optional[ctypes.PyDLL] = None


def python_include() -> Optional[str]:
    """The directory holding Python.h, or None: without it the library has
    no CPython-object routes (`has_object_routes`), and the encode takes its
    UTF-8 route."""
    inc = sysconfig.get_paths().get("include")
    return inc if inc and (Path(inc) / "Python.h").is_file() else None


def flags() -> list:
    inc = python_include()
    return [*CXXFLAGS, *([f"-I{inc}"] if inc else [])]


@functools.lru_cache(maxsize=None)
def _machine() -> str:
    """What `-march=native` means here: g++'s version and the target options
    it enables on this machine, so that a build directory copied to another
    machine never hands it this machine's library."""
    gxx = shutil.which("g++")
    if gxx is None:
        return ""
    version = subprocess.run([gxx, "--version"], capture_output=True, text=True).stdout
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    return version + target


def target(src: Path = SRC, build_dir: Optional[Path] = None) -> Path:
    """The library's path: a hash of the source, the flags and the machine
    names it."""
    if build_dir is None:
        from strsim_tpu_torch.ops._build import BUILD_DIR as build_dir
    h = hashlib.sha256(Path(src).read_bytes())
    h.update(" ".join(flags()).encode())
    h.update(_machine().encode())
    return Path(build_dir) / f"strsim_host-{h.hexdigest()[:16]}.so"


def build_library(src: Path = SRC, build_dir: Optional[Path] = None) -> Path:
    """Compile `src` unless its library exists; return the library's path.
    Raises RuntimeError with the compiler's output if g++ is missing or the
    compile fails."""
    out = target(src, build_dir)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host library needs a C++ compiler")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}.so")
    proc = subprocess.run([gxx, *flags(), str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native host library build failed (g++ exited {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library (built first if needed), with the argument types
    of its array routes declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            signatures = {
                "strsim_decode_utf8_column": (I64, [P, P, P, I64, I32, I32, P, P]),
                "strsim_equal_rows": (I64, [P, P, P, P, I64, I32, I32, P]),
                "strsim_pack_bucket": (I64, [P, P, I32, P, P, P, I64, I32, I32, I32, I32, P, P,
                                             I64]),
                "strsim_compute": (None, [I32, P, P, P, P, P, I64, P]),
                "strsim_compute_mt": (None, [I32, P, P, P, P, P, I64, I32, P]),
                "strsim_phonetic_codes": (None, [I32, P, P, P, I64, I32, I32, P, P]),
                "strsim_finalize_scatter": (None, [I32, P, P, P, P, P, P, I64, P]),
            }
            for name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def get_pylib() -> ctypes.PyDLL:
    """The same library through ctypes.PyDLL: calls through this handle keep
    the GIL held. The CPython-object routes (strsim_scan_object_column,
    strsim_encode_object_column) read a live list's item array and each
    row's str internals, so no other Python thread may run meanwhile (an
    append could move the item array, a store could free a row). The C++
    side threads internally, so holding the GIL costs no parallelism."""
    global _pylib
    get_lib()  # builds under the lock
    with _lock:
        if _pylib is None:
            lib = ctypes.PyDLL(str(target()))
            if hasattr(lib, "strsim_scan_object_column"):
                P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
                lib.strsim_scan_object_column.restype = I64
                lib.strsim_scan_object_column.argtypes = [P, I64, P, P, P, P, P]
                lib.strsim_encode_object_column.restype = I64
                lib.strsim_encode_object_column.argtypes = [P, I64, P, I32, I32, I32, P]
            _pylib = lib
        return _pylib


def has_object_routes() -> bool:
    """True when the library was compiled with Python.h, so the encode can
    read str objects in place."""
    return hasattr(get_pylib(), "strsim_scan_object_column")
