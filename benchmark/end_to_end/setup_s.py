"""Process start to the first timed call: imports, the kernels' load (and
their build on a checkout's first run), the bank's design, the input pool,
and the warm-up calls that capture the cell's CUDA graphs."""


def read(w):
    return w.setup_s
