"""The share of the traced density steps in which the card ran
nothing."""

from portbench import readers


def read(s):
    return readers.idle_pct(s)
