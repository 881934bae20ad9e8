"""Every row of every call that completed in the window (null, equal and
empty rows included) over the window's seconds."""


def read(rec):
    return sum(c.rows for c in rec.done()) / rec.window_s if rec.window_s > 0 else None
