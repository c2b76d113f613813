"""Device operations launched per projection epoch."""

from portbench import readers


def read(s):
    return readers.launches_per_unit(s)
