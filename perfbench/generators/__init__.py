"""Column generators, one module a generator, found by the name a
configuration file gives. Each defines `generate(n, seed, **params) ->
(col_a, col_b)`, two object arrays of str | None."""
