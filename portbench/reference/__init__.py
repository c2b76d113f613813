"""The plain reference: the port's semantics in plain PyTorch, float32
with TF32 off, written from the field's equations and the solver's steps.
It imports neither JAX, nor the JAX package, nor anything of the port,
and takes nothing the port has made: it reads the frozen checkpoints
and the seed, and works everything else out again."""
