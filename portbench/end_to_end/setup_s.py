"""Seconds from process start to the first timed call: imports, the
kernels' build where the checkout has none, loading and warming the cell's
shapes."""


def read(w):
    return w.setup_s
