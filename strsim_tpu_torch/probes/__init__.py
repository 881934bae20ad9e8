"""A/B probes of the port's kernels: hand-written Hopper counterparts of the
JAX package's TPU probes (`tools/ab_*.py`), each with its plain torch
version. `jaro.py` holds the jaro probes K12-K15 (`csrc/probe_jaro.cu`),
`myers.py` the Myers and fused lev + jaro probes K16-K19
(`csrc/probe_myers.cu`, `csrc/probe_fused_lj.cu`), `multiset.py` the
multiset probes K20-K22 (`csrc/probe_multiset.cu`). No path of the engine
imports this package; `tools/ab_torch_jaro.py`, `tools/ab_torch_myers.py`,
`tools/ab_torch_multiset.py` and `chip_smoke.py` drive it."""
