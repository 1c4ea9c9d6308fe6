"""Device ms a step credited to ``train_step/update`` (scrub, Adam, the
densification statistics)."""
from gsbench.roofline import range_ms


def read(run):
    return range_ms(run, "train_step/update")
