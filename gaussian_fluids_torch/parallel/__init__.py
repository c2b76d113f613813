"""Multi-device runs over ``torch.distributed``: the JAX package's
``parallel/`` (``--mesh BxG``). ``mesh`` holds the (batch, gauss) mesh of
ranks and their launcher, ``collectives`` the sums over its axes,
``sharding`` the per-rank fit, clone and projection epochs, ``driver``
the runnable chunk loops and host loops of the frame loop, ``density``
the replay's sharded step. Each rank runs the port's kernels on its own
(batch rows, Gaussian shard) block.
"""

from gaussian_fluids_torch.parallel.mesh import (  # noqa: F401
    Mesh, launch, mesh_from_shape)
