"""Device ms a step credited to the program's ``train_step/forward``
range (render and loss)."""
from gsbench.roofline import range_ms


def read(run):
    return range_ms(run, "train_step/forward")
