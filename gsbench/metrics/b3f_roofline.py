"""B3f (the fast-math forward composite) against its least time on the
reference's count of contributing pairs."""
from gsbench import work
from gsbench.roofline import fwd_kernel, kernel_share


def read(run):
    return kernel_share(run, fwd_kernel(True), work.composite_fwd_s)
