"""Build both native host libraries once, before any test process starts.

`strsim_tpu/native/build.py` compiles into a cache-wide temporary name and
renames it; on a cold cache, pytest-xdist workers that build at once race on
that name, and a worker that loses gives up on the library for its whole
life, so its native tests skip or fail. The port's own library
(`strsim_tpu_torch/native/build.py`) has no such race, but each worker would
compile its 1,100 lines at -O3 on its own. Building both here, in the
controller's `pytest_configure` (which runs before any worker starts; workers
return at once), leaves every worker a built library to load.

The JAX package's build.py is loaded by its file path so that neither
`strsim_tpu` nor jax is imported before tests/conftest.py pins jax to the
CPU; the port's imports torch, not jax. Without a C++ compiler this does
nothing: each process tries again, the JAX package's native tests skip and
the port's raise, as they would without it.
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
    from strsim_tpu_torch.native import build as port_build

    try:
        port_build.build_library()
    except RuntimeError:  # no g++, or it failed: each test process raises it again
        pass
