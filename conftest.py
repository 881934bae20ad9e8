"""Build the native host library once, before any test process starts.

`strsim_tpu/native/build.py` compiles into a cache-wide temporary name and
renames it; on a cold cache, pytest-xdist workers that build at once race on
that name, and a worker that loses gives up on the library for its whole
life, so its native tests skip or fail. Building here, in the controller's
`pytest_configure` (which runs before any worker starts; workers return at
once), leaves every worker a built library to load.

build.py is loaded by its file path so that neither `strsim_tpu` nor jax is
imported before tests/conftest.py pins jax to the CPU. Without a C++
compiler this does nothing, and the tests behave as they would without it.
"""
import importlib.util
import pathlib
import subprocess


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    path = pathlib.Path(__file__).parent / "strsim_tpu" / "native" / "build.py"
    spec = importlib.util.spec_from_file_location("_strsim_native_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    try:
        module.build_library()
    except (OSError, subprocess.CalledProcessError):  # no g++, or it failed:
        pass  # each process tries again and skips its native tests, as before
