"""Kernels, copies and fills launched a training step."""
from gsbench.roofline import launches


def read(run):
    return launches(run)
