"""Wall seconds of the window over the density steps it completed."""


def read(w):
    return w.seconds / w.units
