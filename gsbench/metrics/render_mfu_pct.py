"""A whole view's share of the card's float32 peak: the reference's count
of the render's operations over the traced time a view."""
from gsbench import work
from gsbench.roofline import step_mfu


def read(run):
    return step_mfu(run, lambda w: work.render_flops(w, run.n_rows))
