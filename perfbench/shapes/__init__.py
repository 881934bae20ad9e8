"""Call shapes, one module a shape (`<shape>.py`), found by the name a
traffic file gives under "shape". A shape is everything that depends on
what one call looks like; the harness (`run.py`, `loadgen.py`,
`control.py`, `metrics/kernels_roofline.py`) knows none of it and calls:

  inputs(gen, params, traffic, seed, scale) -> [input, ...]
      the run's inputs, made by the configuration's generator from the
      seed; each has `rows`, the pairs one call on it scores
  select(workload, seed) -> None
      the check's sample of each input, drawn from the seed
  entry(st, measures, cfg, traced) -> fn(input) -> (output, RunMetrics | None)
      the call the window makes (`st` is strsim_tpu_torch; `cfg` None on
      the card, the CPU config in a rehearsal)
  keep(output, input, measures) -> kept
      what the check keeps of one call's output
  reference(workload, dtype) -> {input index: kept}
      the plain reference's answer at the sample, in `keep`'s form, so the
      control can put it in the program's place
  compare(got, want, failed_calls) -> {number: value}
      got: [(input index, kept)] of every call that returned
  LIMITS: {number: limit}, each number `compare` gives and its limit
  work(measures, input) -> (bytes, operations)
      the least work of one call, for the roofline bound (`roofline/_bound.py`)
  widths(input, cfg) -> {bucket width: every row there ASCII}
      the buckets one call reaches, for the kernels that set-up builds
"""
