"""A projection epoch's FLOPs on need against the f32 peak over the
window's time per epoch."""

from portbench import readers


def read(s):
    return readers.mfu_pct(s)
