"""Gaussian Fluids in PyTorch for one NVIDIA H100.

A port of the JAX package ``gaussian_fluids_tpu`` (the reference, kept
beside it unchanged). Plain tensor code is PyTorch; each Pallas kernel of
the reference becomes a CUDA C++ kernel written for Hopper (``csrc/``),
built with ``nvcc`` at first use and bound with ``ctypes``. Every kernel
keeps a plain PyTorch twin in its module, which tensors on the CPU use.

Entry points default to the card (``device="cuda"``); only tests pass
``"cpu"``. This package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from gaussian_fluids_torch.config import FieldSpec  # noqa: F401
from gaussian_fluids_torch.models.mixture import GaussianMixture  # noqa: F401
