"""Host operators the phases dispatch per projection epoch (top-level
``aten::`` operators in the traced calls)."""

from portbench import readers


def read(s):
    return readers.host_ops_per_unit(s)
