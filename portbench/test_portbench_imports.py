"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port: module names are compared by their
top-level name, whole (the port's name begins with the JAX package's)."""

import subprocess
import sys
import types

from portbench import harness

ROOT = str(harness.ROOT)


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("gaussian_fluids_torch_x", "jaxfoo", "flaxen",
                 "gaussian_fluids_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    before = harness.forbidden_modules()
    assert "jaxfoo" not in before and "gaussian_fluids_tpux" not in before
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gaussian_fluids_tpu.ops",
                        types.ModuleType("gaussian_fluids_tpu.ops"))
    assert "gaussian_fluids_tpu" in harness.forbidden_modules()


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    return set(out.stdout.split())


def test_the_harness_and_the_port_load_no_jax():
    tops = _loaded(
        "import portbench.harness, portbench.tracing, portbench.calibrate\n"
        "import portbench.drivers.project, portbench.drivers.replay\n"
        "import gaussian_fluids_torch.solver.project\n"
        "import gaussian_fluids_torch.solver.simulate3d\n"
        "import gaussian_fluids_torch.ops.field")
    assert "gaussian_fluids_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    tops = _loaded("import portbench.reference.plain\n"
                   "import portbench.reference.projection\n"
                   "import portbench.reference.replay\n"
                   "import portbench.frozen, portbench.compare")
    assert "gaussian_fluids_torch" not in tops
    assert not tops & set(harness.FORBIDDEN)
