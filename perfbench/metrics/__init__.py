"""Metric readers, one module a metric of BENCHMARK.json (`<name>.py`, the
name as the manifest gives it), each with `read(rec)` over a
`record.Record`."""
