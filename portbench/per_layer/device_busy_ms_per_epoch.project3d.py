"""Device milliseconds an epoch in the traced projection calls: the
union of the intervals in which any device operation ran, over the
epochs. It reads the device's own work, which the host's speed does not
move, so a gain on the device shows here while the wall-clock metric is
still paced by the host."""

from portbench import readers


def read(s):
    return readers.busy_ms_per_unit(s)
