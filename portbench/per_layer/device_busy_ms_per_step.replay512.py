"""Device milliseconds a density step in the traced replay steps: the
union of the intervals in which any device operation ran, over the
steps. It reads the device's own work, which the host's speed does not
move, so a gain on the device shows here while the wall-clock metric is
still paced by the host."""

from portbench import readers


def read(s):
    return readers.busy_ms_per_unit(s)
