"""Process start to the first timed call: imports, the CUDA context, loading
(or building) the cell's kernels, the inputs made from the seed and one warm
call on each input."""


def read(rec):
    return rec.setup_s
