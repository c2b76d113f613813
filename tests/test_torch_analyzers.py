"""The port's run analyzers (``gaussian_fluids_torch/scripts/analyze_*``)
against the JAX package's ``scripts/analyze_*.py``: the same tiny run
directory (N <= 64, 2-3 frames, written by the JAX package as
tests/test_analyzer_scripts.py writes it) through both, every printed
number equal within 1e-4 relative or one unit of its last printed digit,
and the text between the numbers identical. The JAX scripts run
in-process (``runpy`` with ``sys.argv`` patched), the port's through
``main([..., "--device", "cpu"])``."""

import contextlib
import io
import os
import re
import runpy
import sys

import numpy as np
import pytest

from gaussian_fluids_tpu.config import FieldSpec
from gaussian_fluids_tpu.io.checkpoint import save_checkpoint
from gaussian_fluids_tpu.models.mixture import GaussianMixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TV_RUN = os.path.join(REPO, "runs_r2_evidence", "ckpts", "output_tv")
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _mixture(lo, hi, n, d, rng):
    spec = FieldSpec.create(lo, hi, n, d=d, vdim=d)
    pts = rng.uniform(np.asarray(lo) + 0.1, np.asarray(hi) - 0.1,
                      size=(n, d)).astype(np.float32)
    mix = GaussianMixture.create(pts, spec)
    p = mix.params()
    vals = rng.normal(0.0, 0.5, size=p["values"].shape).astype(np.float32)
    return mix.with_params({**p, "values": vals
                            * np.asarray(mix.alive)[:, None]}), spec


def _write_run(path, lo, hi, n, d, frames):
    rng = np.random.default_rng(0)
    for i in range(frames):
        mix, spec = _mixture(lo, hi, n, d, rng)
        f = os.path.join(path, f"gaussian_velocity_{i}.pt")
        save_checkpoint(f, mix, spec)
        # mtimes 10 s apart: the wall-clock lines print
        os.utime(f, (1.0e9 + 10.0 * i, 1.0e9 + 10.0 * i))
    return path


def _scene_run(path, scene, n=24, frames=3):
    """A 2D run over the scene's visualize domain in its target space."""
    from gaussian_fluids_tpu.scenes import get_scene_2d
    sc = get_scene_2d(scene)
    sf = sc.scaling_factor
    x0, x1, y0, y1 = np.asarray(sc.visualize_domain)
    return _write_run(path, (x0 * sf - 1, y0 * sf - 1),
                      (x1 * sf + 1, y1 * sf + 1), n, 2, frames)


def _karman_run(path):
    from gaussian_fluids_tpu.scenes import get_scene_2d
    sc = get_scene_2d("karman")
    x0, x1, y0, y1 = np.asarray(sc.visualize_domain) * sc.scaling_factor
    return _write_run(path, (x0 - 1, y0 - 1), (x1 + 1, y1 + 1), 24, 2, 3)


def _ab_runs(path):
    a, b = os.path.join(path, "exact"), os.path.join(path, "cached")
    os.makedirs(a)
    os.makedirs(b)
    rng = np.random.default_rng(0)
    for i in range(3):
        mix, spec = _mixture((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 16, 3, rng)
        for d in (a, b):
            save_checkpoint(os.path.join(d, f"gaussian_velocity_{i}.pt"),
                            mix, spec)
    return a, b


def _density_run(path):
    from gaussian_fluids_tpu.io.vti import write_vti_array
    n = 10
    g = np.arange(n) / n
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    for tag, c0, c1 in (("a", 0.3, 0.4), ("b", 0.7, 0.6)):
        for i, c in enumerate((c0, c1)):
            v = np.exp(-(((X - c) ** 2 + (Y - .5) ** 2 + (Z - .5) ** 2)
                         / 0.02)).astype(np.float32)
            write_vti_array(v, (0, 0, 0), (1 / n,) * 3,
                            os.path.join(path, f"density_{tag}_{i}.vti"))
    return path


def _tv_subset(path):
    """Frames 0, 10 and 40 of the committed Taylor-vortex run, linked: a
    stride of 40 samples the first and the last (frame 400's 65,941
    Gaussians would take GBs of dense CPU evaluation in each package)."""
    for n in (0, 10, 40):
        os.symlink(os.path.join(TV_RUN, f"gaussian_velocity_{n}.pt"),
                   os.path.join(path, f"gaussian_velocity_{n}.pt"))
    return path


CASES = {
    "leapfrog2d": (lambda p: _write_run(p, (-5.2, -4.2), (5.2, 4.2), 24, 2,
                                        3), ["2"]),
    "taylor_green2d": (lambda p: _scene_run(p, "taylor_green"), ["2"]),
    "taylor_vortex2d": (lambda p: _scene_run(p, "taylor_vortex"), ["2"]),
    "vortices_pass2d": (lambda p: _scene_run(p, "vortices_pass_noslip"),
                        ["vortices_pass_noslip", "2"]),
    "karman2d": (_karman_run, ["2"]),
    "ring3d": (lambda p: _write_run(p, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 16,
                                    3, 2), ["1", "8"]),
    "rc_tg128_ab": (lambda p: _ab_runs(p), ["1", "8"]),
    "density3d": (_density_run, []),
    "taylor_vortex2d_committed": (_tv_subset, ["40"]),
}


def _jax_output(script, args):
    argv = sys.argv
    out = io.StringIO()
    sys.argv = [script] + args
    try:
        with contextlib.redirect_stdout(out):
            try:
                runpy.run_path(os.path.join(REPO, "scripts", script),
                               run_name="__main__")
            except SystemExit as e:
                assert e.code in (0, None), e.code
    finally:
        sys.argv = argv
    return out.getvalue()


def _port_output(module, args):
    import importlib
    mod = importlib.import_module(f"gaussian_fluids_torch.scripts.{module}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(args + ["--device", "cpu"]) == 0
    return out.getvalue()


def _unit(tok: str) -> float:
    """One unit of the last printed digit of a number token."""
    mant, _, exp = tok.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - decimals)


def assert_same_numbers(got: str, want: str):
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines), (got, want)
    for g, w in zip(g_lines, w_lines):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            x, y = float(a), float(b)
            assert abs(x - y) <= max(1e-4 * abs(y), _unit(b) * 1.0001), \
                (a, b, g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_port_analyzer_prints_the_jax_numbers(case, tmp_path):
    make, args = CASES[case]
    name = case.replace("_committed", "")
    if case == "rc_tg128_ab":
        args = list(make(str(tmp_path))) + args
    else:
        args = [make(str(tmp_path))] + args
    want = _jax_output(f"analyze_{name}.py", args)
    got = _port_output(f"analyze_{name}", args)
    rows = [ln for ln in got.splitlines() if ln.strip()[:1].isdigit()]
    assert rows, got
    assert_same_numbers(got, want)


def test_ring3d_mesh_flux_column(tmp_path):
    """With an obstacle scene the port adds the mesh-flux column, as the
    JAX script does; every other number agrees with the JAX script's (the
    mesh's probe points come from each package's own random stream)."""
    run = _write_run(str(tmp_path), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 16,
                     3, 2)
    args = [run, "1", "8", "ring_with_obstacle"]
    want = _jax_output("analyze_ring3d.py", args)
    got = _port_output("analyze_ring3d", args)
    assert "meshflux" in next(ln for ln in got.splitlines()
                              if ln.split()[:1] == ["frame"])
    drop = lambda s: "\n".join(" ".join(ln.split()[:-1])
                               if ln.strip()[:1].isdigit() else ln
                               for ln in s.splitlines())
    assert_same_numbers(drop(got), drop(want))
    flux = [float(ln.split()[-1]) for ln in got.splitlines()
            if ln.strip()[:1].isdigit()]
    assert len(flux) == 2 and all(np.isfinite(flux))


def test_number_comparison_catches_a_last_digit_miss():
    assert_same_numbers("x 1.234e-02 0.0576", "x 1.235e-02 0.0577")
    with pytest.raises(AssertionError):
        assert_same_numbers("x 0.0576", "x 0.0578")
    with pytest.raises(AssertionError):
        assert_same_numbers("PASS 1.0", "FAIL 1.0")
