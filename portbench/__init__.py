"""The benchmark of the PyTorch and CUDA port (``gaussian_fluids_torch``)
on one H100: projection epochs of Ring-Collide (3D) and Taylor-vortex
(2D) and the 512^3 density replay, driven by the data files beside this
one. It imports neither JAX nor the JAX package; its plain reference
(``portbench/reference``) imports nothing of the port either."""
