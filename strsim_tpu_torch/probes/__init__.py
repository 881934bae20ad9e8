"""A/B probes of the port's kernels: hand-written Hopper counterparts of the
JAX package's TPU probes (`tools/ab_*.py`), each with its plain torch
version. No path of the engine imports this package; `tools/ab_torch_*.py`
and `chip_smoke.py` drive it."""
