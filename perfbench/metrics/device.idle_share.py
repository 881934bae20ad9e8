"""1 - (union of the device ops' intervals) / the traced window's wall, in %."""


def read(rec):
    if rec.trace is None or not rec.trace.device or rec.window_s <= 0:
        return None
    return (1.0 - rec.trace.busy_s() / rec.window_s) * 100.0
