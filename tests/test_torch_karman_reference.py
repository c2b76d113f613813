"""The port's Karman projection on the CPU against the benchmark's plain
reference (``portbench/reference/karman.py``, which imports nothing of
the port): the first three steps of ``project_2d`` from an advected
checkpoint (each step's loss, the first step's gradients, the parameters
after the third) on two frames' advance domains; the reference's
cylinder and edge draws against ``scenes/boundaries2d.py`` on the same
uniforms; and the comparison failing where the reference's inflow flux
has its sign flipped or its advance domain is held at frame 0's. The
port runs the plain twins of the centered kernels its card path takes
(``GF_FIELD_BACKEND=pallas``), with that path's sorts and hoisted
targets."""

import pytest
import torch

from gaussian_fluids_torch.io import checkpoint
from gaussian_fluids_torch.scenes import boundaries2d, get_scene_2d
from gaussian_fluids_torch.solver import advect_field, optim, project
from gaussian_fluids_torch.utils.grids import grid_points_2d
from portbench import compare, harness
from portbench.reference import karman as reference

from torch_karman_state import karman_frame

STEPS, BATCH, N = 3, 256, 1024
GEN_SEED = 11
FRAMES = (10, 150)   # the advance domain's left edge moved 0.28 and 3.78
LIMITS = {"loss1_gap": 1e-5, "loss_gap": 1e-4, "grad_gap": 1e-5,
          "step_gap": 1e-4}


def config():
    cfg = harness.find_cell("karman.project").config
    cfg.update({"batch": BATCH, "test_res": [12, 6]})
    return cfg


def port_steps(path, frame, cfg, monkeypatch):
    """The port's first ``STEPS`` projection steps from the checkpoint of
    ``frame``, as the comparison reads them."""
    monkeypatch.setenv("GF_FIELD_BACKEND", "pallas")
    scene = get_scene_2d("karman")
    dt, sf = float(cfg["dt"]), scene.scaling_factor
    old, spec = checkpoint.load_checkpoint(str(path), device="cpu")
    mix = advect_field.advect_covector_field_2d(old, spec, dt)
    start = {k: p.detach().clone() for k, p in mix.params().items()}
    adv = scene.advance_domain_at(frame + 1, dt)
    test_x = grid_points_2d(adv[0] * sf, adv[1] * sf, adv[2] * sf,
                            adv[3] * sf, *cfg["test_res"])
    rec = {"losses": [], "grads": None, "after": None}
    step = optim.step

    def recorded(state, params, grads, metric):
        out = step(state, params, grads, metric)
        rec["losses"].append(float(metric))
        if rec["grads"] is None:
            rec["grads"] = {k: g.clone() for k, g in grads.items()}
        rec["after"] = {k: p.clone() for k, p in out[0].items()}
        return out

    monkeypatch.setattr(optim, "step", recorded)
    project.project_2d(
        mix, spec, old, dt, scene=scene, adv_domain=adv, test_x=test_x,
        gen=torch.Generator().manual_seed(GEN_SEED),
        weights=project.ProjectWeights(**cfg["weights"]),
        boundary_lambda=float(cfg["boundary_lambda"]), batch_size=BATCH,
        max_epoch=STEPS, patience=STEPS, check_iter=STEPS, verbose=0)
    return compare.step_norms(rec["losses"], rec["grads"],
                              {k: rec["after"][k] - start[k] for k in start})


def reference_steps(path, frame, cfg):
    ref = reference.first_steps(cfg, frame, str(path), GEN_SEED, "cpu",
                                STEPS)
    return compare.step_norms(ref["losses"], ref["grads"], ref["delta"])


def gaps(tmp_path, frame, monkeypatch):
    cfg = config()
    path = karman_frame(tmp_path / "frame.pt", N, seed=frame)
    return compare.training_gaps(port_steps(path, frame, cfg, monkeypatch),
                                 reference_steps(path, frame, cfg))


@pytest.mark.parametrize("frame", FRAMES)
def test_the_ports_first_steps_follow_the_reference(tmp_path, monkeypatch,
                                                    frame):
    got = gaps(tmp_path, frame, monkeypatch)
    for k, lim in LIMITS.items():
        assert got[k] < lim, (k, got)


@pytest.mark.parametrize("frame", FRAMES)
def test_the_reference_draws_the_ports_boundary_batches(frame):
    cfg = config()
    scene = get_scene_2d("karman")
    sf = scene.scaling_factor
    adv = torch.tensor(scene.advance_domain_at(frame, float(cfg["dt"])),
                       dtype=torch.float32)
    assert tuple(adv.tolist()) == tuple(
        torch.tensor(reference.advance_domain(cfg, frame)).tolist())
    assert sf == cfg["scaling_factor"]
    g = torch.Generator().manual_seed(frame)
    u, u1, u2 = torch.rand((3, 300), generator=g)
    for a, b in zip(boundaries2d.karman_cylinder(u, scene.info, sf),
                    reference.cylinder(u, cfg, sf)):
        assert torch.equal(a, b)
    port = boundaries2d.karman_edges(u1, u2, adv, scene.info, sf)
    ref = reference.edges(u1, u2, adv, cfg, sf)
    assert port[0].shape == (1500, 2)
    for a, b in zip(port, ref):
        assert torch.equal(a, b)
    # the fluxes: none through the lower and upper edges, the inflow in
    # through both left edges and out through the right one
    flux = ref[2].reshape(5, 300)[:, 0] / sf
    assert flux.tolist() == [0.0, 0.0, 0.5, -0.5, 0.5]


def _flipped(edges):
    def f(*a, **k):
        pts, normals, flux = edges(*a, **k)
        return pts, normals, -flux
    return f


@pytest.mark.parametrize("fault", ["inflow_sign_flipped",
                                   "domain_held_fixed"])
def test_the_comparison_sees_a_wrong_boundary(tmp_path, monkeypatch, fault):
    if fault == "inflow_sign_flipped":
        monkeypatch.setattr(reference, "edges", _flipped(reference.edges))
    else:
        fixed = reference.advance_domain
        monkeypatch.setattr(reference, "advance_domain",
                            lambda cfg, frame: fixed(cfg, 0))
    got = gaps(tmp_path, FRAMES[1], monkeypatch)
    assert any(got[k] >= lim for k, lim in LIMITS.items()), got
