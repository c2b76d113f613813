"""Device operations launched per density step."""

from portbench import readers


def read(s):
    return readers.launches_per_unit(s)
