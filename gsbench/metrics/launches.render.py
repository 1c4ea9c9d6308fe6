"""Kernels, copies and fills launched a view."""
from gsbench.roofline import launches


def read(run):
    return launches(run)
