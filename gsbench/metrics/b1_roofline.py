"""B1 (the exact forward composite) against its least time on the
reference's count of contributing pairs."""
from gsbench import work
from gsbench.roofline import fwd_kernel, kernel_share


def read(run):
    return kernel_share(run, fwd_kernel(False), work.composite_fwd_s)
