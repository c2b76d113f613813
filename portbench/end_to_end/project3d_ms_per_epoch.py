"""Wall milliseconds of the window over the projection epochs it
completed."""


def read(w):
    return 1e3 * w.seconds / w.units
