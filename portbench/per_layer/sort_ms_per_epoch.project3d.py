"""Device milliseconds per 3D projection epoch in sort kernels (the
field's work lists and the batches' key sorts), matched by name."""

from portbench import readers

KERNELS = r"(?i)radix|sort"


def read(s):
    return readers.device_ms_per_unit(s, KERNELS)
