"""Device ms a step credited to ``train_step/backward`` (autograd: B3b,
the gathers' scatter-add, the projection's reverse pass)."""
from gsbench.roofline import range_ms


def read(run):
    return range_ms(run, "train_step/backward")
