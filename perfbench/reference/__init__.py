"""The plain reference, one module a measure (`<measure>.py`), each with
`scores(a, b, dtype=np.float64)`. See `_rows.py`."""
