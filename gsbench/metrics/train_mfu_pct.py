"""The whole training step's share of the card's float32 peak: the
reference's count of the step's operations over the traced step time."""
from gsbench import work
from gsbench.roofline import step_mfu


def read(run):
    return step_mfu(run, lambda w: work.train_flops(
        w, run.n_rows, run.n_params, run.grow_rows))
