"""B3b (the fast-math composite backward) against its least time on the
reference's count of contributing pairs."""
from gsbench import work
from gsbench.roofline import b3b, kernel_share


def read(run):
    return kernel_share(run, b3b, work.composite_bwd_s)
