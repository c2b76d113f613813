"""Host operators the replay's chunk loop dispatches per density step."""

from portbench import readers


def read(s):
    return readers.host_ops_per_unit(s)
