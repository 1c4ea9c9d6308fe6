"""Share of the traced window's host span in which no device operation
ran (rendering)."""
from gsbench.roofline import idle_pct


def read(run):
    return idle_pct(run)
