"""The centered forward kernel's share of its roofline on Karman's 2D
epochs (row 1 at d = 2: the target's RK4 stages, the heads' forward, the
cylinder's and the edges' values, the test grid): its least time on
need, counted from the calls' own inputs, over its device time."""

from portbench import readers

KERNELS = r"gsr_fwd_kernel"
PROBES = [("gaussian_fluids_torch.ops.gsr_centered", "gsr_fwd")]


def read(s):
    return readers.roofline_pct(s, KERNELS, PROBES[0])
