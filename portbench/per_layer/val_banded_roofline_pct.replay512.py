"""The banded value kernel's share of its roofline: its least time on
need, counted from the calls' own inputs, over its device time."""

from portbench import readers

KERNELS = r"val_banded_kernel"
PROBES = [("gaussian_fluids_torch.ops.gsr_banded", "gsr_value_banded")]


def read(s):
    return readers.roofline_pct(s, KERNELS, PROBES[0])
