"""Import guard for the PyTorch port: every module of gaussian_fluids_torch
and chip_smoke.py imports only the standard library, torch, numpy, scipy,
einops and the port itself — never jax, the JAX package or matplotlib,
none of which the card's machine has or the port may lean on. The one
exception: a drawing function may import matplotlib inside its body
(never at a module's top), and importing the port loads none of them."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gaussian_fluids_torch")
ALLOWED = {"torch", "numpy", "scipy", "einops", "gaussian_fluids_torch",
           "__future__"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


# imported inside a drawing function only, never at a module's top: a
# run without it prints one line and draws nothing (io/viz2d.py)
ALLOWED_IN_FUNCTIONS = {"matplotlib"}

# the run analyzers, one per JAX script of the same name
ANALYZERS = ("leapfrog2d", "taylor_green2d", "taylor_vortex2d",
             "vortices_pass2d", "karman2d", "ring3d", "rc_tg128_ab",
             "density3d")


def _imports(path):
    """(root module, whether inside a function body) of each import."""
    tree = ast.parse(open(path).read(), filename=path)
    nested = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested |= {id(n) for n in ast.walk(node)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], id(node) in nested
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], id(node) in nested


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_imports_only_allowed_modules(path):
    bad = sorted({m for m, inner in _imports(path)
                  if m not in ALLOWED and m not in sys.stdlib_module_names
                  and not (inner and m in ALLOWED_IN_FUNCTIONS)})
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_guard_sees_the_whole_package():
    rel = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {"chip_smoke.py", "gaussian_fluids_torch/ops/gsr_centered.py",
            "gaussian_fluids_torch/ops/gsr_cells.py",
            "gaussian_fluids_torch/ops/spatial.py",
            "gaussian_fluids_torch/solver/project.py",
            "gaussian_fluids_torch/solver/simulate3d.py",
            "gaussian_fluids_torch/scenes/fields3d.py",
            "gaussian_fluids_torch/ops/gsr_banded.py",
            "gaussian_fluids_torch/ops/interp.py",
            "gaussian_fluids_torch/io/vti.py",
            "gaussian_fluids_torch/advance_density3d.py",
            "gaussian_fluids_torch/ops/rk4_fused.py",
            "gaussian_fluids_torch/solver/covector.py",
            "gaussian_fluids_torch/scenes/boundaries2d.py",
            "gaussian_fluids_torch/parallel/__init__.py",
            "gaussian_fluids_torch/parallel/mesh.py",
            "gaussian_fluids_torch/parallel/collectives.py",
            "gaussian_fluids_torch/parallel/sharding.py",
            "gaussian_fluids_torch/parallel/driver.py",
            "gaussian_fluids_torch/parallel/density.py",
            "gaussian_fluids_torch/mesh_check.py",
            "gaussian_fluids_torch/ops/sparse.py",
            "gaussian_fluids_torch/solver/sampling.py",
            "gaussian_fluids_torch/io/viz2d.py",
            "gaussian_fluids_torch/utils/profiling.py",
            "gaussian_fluids_torch/utils/roofline.py",
            "gaussian_fluids_torch/scripts/_runs.py",
            "gaussian_fluids_torch/scripts/production.py",
            "gaussian_fluids_torch/scripts/report_runs.py"} <= rel
    for name in ANALYZERS:
        assert f"gaussian_fluids_torch/scripts/analyze_{name}.py" in rel
    for src in ("gsr_centered.cu", "gsr_cells.cu", "gsr_banded.cu",
                "rk4_fused.cu", "gsr_tile.cuh"):
        assert os.path.exists(os.path.join(PKG, "csrc", src))


def test_importing_the_port_loads_no_jax():
    code = ("import sys, gaussian_fluids_torch.solver.simulate2d, "
            "gaussian_fluids_torch.advance2d, "
            "gaussian_fluids_torch.initialize2d, "
            "gaussian_fluids_torch.solver.simulate3d, "
            "gaussian_fluids_torch.advance3d, "
            "gaussian_fluids_torch.initialize3d, "
            "gaussian_fluids_torch.advance_density3d, "
            "gaussian_fluids_torch.ops.gsr_banded, "
            "gaussian_fluids_torch.ops.interp, "
            "gaussian_fluids_torch.io.vti, "
            "gaussian_fluids_torch.ops.rk4_fused, "
            "gaussian_fluids_torch.epoch_profile, "
            "gaussian_fluids_torch.parallel, "
            "gaussian_fluids_torch.parallel.mesh, "
            "gaussian_fluids_torch.parallel.collectives, "
            "gaussian_fluids_torch.parallel.sharding, "
            "gaussian_fluids_torch.parallel.driver, "
            "gaussian_fluids_torch.parallel.density, "
            "gaussian_fluids_torch.mesh_check, "
            "gaussian_fluids_torch.ops.sparse, "
            "gaussian_fluids_torch.solver.sampling, "
            "gaussian_fluids_torch.io.viz2d, "
            "gaussian_fluids_torch.utils.profiling, "
            "gaussian_fluids_torch.utils.roofline, "
            "gaussian_fluids_torch.scripts.production, "
            "gaussian_fluids_torch.scripts.report_runs, "
            + ", ".join(f"gaussian_fluids_torch.scripts.analyze_{name}"
                        for name in ANALYZERS) + "\n"
            "bad = [m for m in ('jax', 'gaussian_fluids_tpu', 'matplotlib')"
            " if m in sys.modules]\n"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)
