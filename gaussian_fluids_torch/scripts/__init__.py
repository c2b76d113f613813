"""The run analyzers on the port: each module reads a run directory's
``gaussian_velocity_{n}.pt`` checkpoints (or ``density_{tag}_{n}.vti``
volumes) through the port's own modules and prints the table of the JAX
package's ``scripts/analyze_*.py`` of the same name, on the card by
default (``--device cpu`` on request):

    python -m gaussian_fluids_torch.scripts.analyze_ring3d RUN_DIR [stride]
"""
