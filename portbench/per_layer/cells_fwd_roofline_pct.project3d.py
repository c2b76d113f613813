"""The cells forward kernel's share of its roofline: its least time on
need, counted from the calls' own inputs, over its device time."""

from portbench import readers

KERNELS = r"cells_fwd_kernel"
PROBES = [("gaussian_fluids_torch.ops.gsr_cells", "cells_fwd")]


def read(s):
    return readers.roofline_pct(s, KERNELS, PROBES[0])
