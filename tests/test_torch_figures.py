"""The port's figures against the JAX package's.

2D (Taylor-Green, 576 Gaussians): ``show_field`` is patched in both
packages to capture the array each figure is handed (the port's still
draws its PNGs). ``initialize_2d(viz=True)`` with no fit epochs, so both
packages hold the same initial mixture: the three reference figures and
frame 0 agree; one ``advance_2d`` frame from the JAX package's checkpoint
0: the start frame's figures agree, and frame 1's agree with the JAX
package's figure sweeps of the port's own frame-1 checkpoint. The PNG
names equal the JAX package's figure names, and a resumed run draws a
deleted frame's PNGs again. PNG bytes are not compared. Arrays within
1e-5 of the largest entry (the figures' field sweeps).

3D: ``project_3d(collect_curves=True)`` with lrs of 1e-30, so neither
package moves its parameters: the curves have the JAX package's lengths,
the test curves agree within 5e-5 of the largest entry and the lr curve
within rtol 1e-6 (the batches differ, so the train curves are only
finite).

Without matplotlib (a subprocess where ``import matplotlib`` fails) a 2D
and a 3D entry point each print the one line, draw no PNG and finish.
"""

import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from gaussian_fluids_torch.io import viz2d as tviz
from gaussian_fluids_torch.solver import simulate2d as tsim
from gaussian_fluids_tpu.io import checkpoint as jckpt
from gaussian_fluids_tpu.io import viz2d as jviz
from gaussian_fluids_tpu.scenes import get_scene_2d as jscene
from gaussian_fluids_tpu.solver import simulate2d as jsim

from torch_parity import close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
# the test curves are means of |curl - target| whose targets come from
# the RK4 deformation backtrace and a batched 3x3 solve: f32 agreement
# of the two packages there is ~1.2e-5 of the value
CURVE_TOL = 5e-5
ADV = dict(dt=.001, last_time=.001, max_epoch=5, test_res=(20, 20),
           verbose=0)


class _Capture:
    """``show_field`` that records {file name: array handed to it}, and
    draws too where ``draw``."""

    def __init__(self, grid_fn, original=None):
        self.grid_fn, self.original, self.seen = grid_fn, original, {}
        self.lock = threading.Lock()

    def __call__(self, field_fn, x_min, x_max, y_min, y_max, dim=1, x_n=100,
                 y_n=100, additional_drawing=None, save_filename=None):
        out = np.asarray(field_fn(self.grid_fn(x_min, x_max, y_min, y_max,
                                               x_n, y_n)))
        with self.lock:
            self.seen[os.path.basename(save_filename)] = out
        if self.original is not None:
            self.original(field_fn, x_min, x_max, y_min, y_max, dim, x_n,
                          y_n, additional_drawing, save_filename)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from gaussian_fluids_torch.utils.grids import grid_points_2d as tgrid
    from gaussian_fluids_tpu.utils.grids import grid_points_2d as jgrid
    jdir = str(tmp_path_factory.mktemp("jax_fig"))
    tdir = str(tmp_path_factory.mktemp("torch_fig"))
    mp = pytest.MonkeyPatch()
    jcap = _Capture(jgrid)
    tcap = _Capture(tgrid, tviz.show_field)
    mp.setattr(jviz, "show_field", jcap)
    mp.setattr(tviz, "show_field", tcap)
    try:
        jsim.initialize_2d("taylor_green", jdir, max_epoch=0, verbose=0)
        tsim.initialize_2d("taylor_green", tdir, max_epoch=0, verbose=0,
                           device="cpu")
        init = (dict(jcap.seen), dict(tcap.seen))
        jcap.seen.clear()
        tcap.seen.clear()
        shutil.copy(os.path.join(jdir, "gaussian_velocity_0.pt"), tdir)
        jsim.advance_2d("taylor_green", jdir, **ADV)
        tsim.advance_2d("taylor_green", tdir, **ADV, device="cpu")
        adv = (dict(jcap.seen), dict(tcap.seen))
        # the JAX package's sweeps of the port's frame 1
        jcap.seen.clear()
        jm, spec = jckpt.load_checkpoint(
            os.path.join(tdir, "gaussian_velocity_1.pt"))
        jsim._viz_frame(jdir, "port1", jm, spec, jscene("taylor_green"))
        port1 = dict(jcap.seen)
    finally:
        mp.undo()
    return jdir, tdir, init, adv, port1


def test_reference_and_frame_0_figures_match(runs):
    _, _, (j, t), _, _ = runs
    assert sorted(t) == sorted(j) == sorted(
        ["refvelocity.png", "refvorticity.png", "refdivergence.png",
         "0.png", "clean_0.png", "vorticity_0.png", "divergence_0.png"])
    for name in j:
        assert t[name].shape == j[name].shape, name
        close(t[name], j[name], TOL, err_msg=name)


def test_advance_figures_match(runs):
    _, _, _, (j, t), port1 = runs
    assert sorted(t) == sorted(j)
    for name in ("0.png", "clean_0.png", "vorticity_0.png",
                 "divergence_0.png"):
        close(t[name], j[name], TOL, err_msg=name)
    for name in ("1.png", "clean_1.png", "vorticity_1.png",
                 "divergence_1.png"):
        close(t[name], port1[name.replace("1", "port1", 1)
                             if name[0] == "1" else
                             name.replace("_1", "_port1")], TOL,
              err_msg=name)


def test_png_names_and_resume_backfill(runs):
    _, tdir, (jinit, _), (jadv, _), _ = runs
    pngs = sorted(f for f in os.listdir(tdir) if f.endswith(".png"))
    assert pngs == sorted(set(jinit) | set(jadv))
    frame0 = ["0.png", "clean_0.png", "vorticity_0.png", "divergence_0.png"]
    for f in frame0:
        os.remove(os.path.join(tdir, f))
    tsim.advance_2d("taylor_green", tdir, dt=.001, last_time=0.0,
                    start_frame=1, verbose=0, device="cpu")
    assert set(frame0) <= set(os.listdir(tdir))


def test_project_3d_curves_match():
    from gaussian_fluids_torch.solver import project as tproj
    from gaussian_fluids_tpu.solver import project as jproj
    from torch_parity import jax_mixture_3d, to_torch
    import jax
    jm, spec = jax_mixture_3d(256, 3)
    tm, ts = to_torch(jm, spec)
    g = np.linspace(0.1, 0.9, 6, dtype=np.float32)
    test_x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    lrs = {k: 1e-30 for k in ("positions", "scalings", "rotations",
                              "values")}
    kw = dict(domain=(0, 1, 0, 1, 0, 1), test_x=test_x, lrs=lrs,
              batch_size=64, max_epoch=6, check_iter=4, verbose=0,
              boundary_lambda=0.0, collect_curves=True)
    _, jc = jproj.project_3d(jm, spec, jm, 0.01, key=jax.random.PRNGKey(0),
                             **kw)
    _, _, tc = tproj.project_3d(tm, ts, tm, 0.01,
                                gen=torch.Generator().manual_seed(0), **kw)
    for k in jc:
        assert len(tc[k]) == len(jc[k]), k
        assert np.isfinite(tc[k]).all(), k
    assert len(tc["train_vor"]) == 6 and len(tc["test_vor"]) == 2
    np.testing.assert_allclose(tc["log_lr"], jc["log_lr"], rtol=1e-6)
    for k in ("test_vor", "test_div"):
        close(np.asarray(tc[k]), np.asarray(jc[k]), CURVE_TOL, err_msg=k)


SCRIPT = r"""
import os, sys
sys.modules["matplotlib"] = None          # import matplotlib fails
from gaussian_fluids_torch.scenes import fields3d
fields3d.PARTICLE_COUNT["leapfrog"] = (4, 4, 4)
fields3d.VISUALIZE_RES["leapfrog"] = (8, 8, 8)
from gaussian_fluids_torch import (advance2d, advance3d, initialize2d,
                                   initialize3d)
d2, d3 = sys.argv[1], sys.argv[2]
common = ["--device", "cpu", "--max_epoch", "3"]
initialize2d.main(common + ["--init_cond", "taylor_green", "--dir", d2])
advance2d.main(common + ["--init_cond", "taylor_green", "--dir", d2,
                         "--dt", ".001", "--last_time", ".001"])
initialize3d.main(common + ["--init_cond", "leapfrog", "--dir", d3])
advance3d.main(common + ["--init_cond", "leapfrog", "--dir", d3,
                         "--dt", ".02", "--last_time", ".02"])
print("FINISHED")
"""


def test_without_matplotlib_runs_say_so_and_draw_nothing(tmp_path):
    d2, d3 = str(tmp_path / "d2"), str(tmp_path / "d3")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT, d2, d3], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines()
             if "matplotlib is not installed" in ln]
    # one line for each 2D run, one for the 3D frame loop
    assert len(lines) == 3, out.stdout[-3000:]
    assert sum("2D figures" in ln for ln in lines) == 2
    assert sum("loss_{n}.png" in ln for ln in lines) == 1
    assert out.stdout.strip().endswith("FINISHED")
    for d in (d2, d3):
        assert not [f for f in os.listdir(d) if f.endswith(".png")]
    assert "gaussian_velocity_1.pt" in os.listdir(d2)
    assert "vorticity_1.vti" in os.listdir(d3)   # volumes still written
