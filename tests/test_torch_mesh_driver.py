"""The port's multi-device runners on gloo meshes of CPU processes: the
mesh and its launcher, the chunk runners against repeated epochs (bitwise:
the same epochs on the same draws), the sharded density step against the
port's single-device step and the JAX package's sharded step on its
4 x 2 virtual mesh (rtol 1e-5, atol 1e-6, as ``tests/test_parallel.py``),
the clone and projection host loops end to end, and the dry run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from gaussian_fluids_torch.models.mixture import (GaussianMixture as TMix,
                                                  mixture_of)
from gaussian_fluids_torch.ops import field as tfield
from gaussian_fluids_torch.parallel import sharding as tsh
from gaussian_fluids_torch.parallel.mesh import launch
from gaussian_fluids_torch.solver import clone as tclone
from gaussian_fluids_torch.solver import losses
from gaussian_fluids_torch.config import FieldSpec as TSpec
from gaussian_fluids_tpu import FieldSpec, GaussianMixture
from gaussian_fluids_tpu.parallel import density as jdensity
from gaussian_fluids_tpu.parallel import sharding as jsh

import torch_mesh_ranks as ranks
from test_torch_mesh_epochs import SHAPES, build_cases

RANK_TIMEOUT = 300
IDS = [f"{b}x{g}" for b, g in SHAPES]


def _launch(fn, shape, *args):
    return launch(fn, shape, args, device="cpu", timeout=RANK_TIMEOUT,
                  threads=1)


# ---- the mesh ----

def test_mesh_coordinates_generators_and_gathers():
    """Ranks sit row-major, and lay out anew as 1 x 4 (``reshape``, whose
    gauss group then holds all four); the ranks of a batch row draw
    alike, the rows differently; shards gather back exactly (floats and
    bools); a broadcast gives rank 0's value everywhere."""
    out = _launch(ranks.basics_rank, (2, 2))
    assert [o["coords"] for o in out] == [(0, 0, 0, 4), (0, 1, 1, 4),
                                          (1, 0, 2, 4), (1, 1, 3, 4)]
    assert [o["reshaped"] for o in out] == [(0, r, r, 4.0)
                                            for r in range(4)]
    np.testing.assert_array_equal(out[0]["draw"], out[1]["draw"])
    np.testing.assert_array_equal(out[2]["draw"], out[3]["draw"])
    assert not np.array_equal(out[0]["draw"], out[2]["draw"])
    for o in out:
        np.testing.assert_array_equal(o["gathered"], np.arange(16.0))
        np.testing.assert_array_equal(o["mask"], np.arange(16) % 3 == 0)
        np.testing.assert_array_equal(o["broadcast"], [7.0])


def test_a_failing_rank_fails_the_run():
    """A rank that raises ends the others, which wait in a collective, and
    the launch raises with its error."""
    with pytest.raises(tmp.ProcessRaisedException, match="rank 1 failed"):
        _launch(ranks.failing_rank, (1, 2))


def test_a_run_past_its_timeout_is_killed():
    with pytest.raises(TimeoutError):
        launch(ranks.sleeping_rank, (2, 1), (120,), device="cpu", timeout=5)


def test_indivisible_capacity_is_refused():
    class M:
        n_gauss = 3
    with pytest.raises(ValueError, match="does not split"):
        tsh.check_divisible(512, M)


# ---- chunk runners ----

CHUNK_KINDS = ["project_leapfrog", "clone_2d", "project_3d"]


@pytest.fixture(scope="module")
def chunk_cases():
    cases = {k: c for k, (c, _) in build_cases().items()
             if k in CHUNK_KINDS}
    for c in cases.values():
        c["batch"] = 32
    return cases


@pytest.fixture(scope="module")
def chunks(chunk_cases):
    got = {}

    def at(shape):
        if shape not in got:
            got[shape] = _launch(ranks.chunk_rank, shape, chunk_cases, 3)
        return got[shape]
    return at


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("kind", CHUNK_KINDS)
def test_chunk_runner_matches_repeated_epochs(kind, shape, chunks):
    """Three epochs of a chunk runner equal three epoch calls on the
    batches a twin generator draws in the runner's order, bitwise, on
    every rank."""
    for per_rank in chunks(shape):
        assert per_rank[kind] == 0.0, per_rank[kind]


# ---- the density step ----

@pytest.fixture(scope="module")
def density_case():
    """tests/test_parallel.py's density step: 64 Gaussians in [-1, 1]^3,
    a 12^3 volume, dt .05, chunks of 512 nodes."""
    n = 64
    spec = FieldSpec.create((-1, -1, -1), (1, 1, 1), n, d=3, vdim=3)
    r = np.random.RandomState(7)
    mix = GaussianMixture.create(r.uniform(-0.8, 0.8, (n, 3)), spec,
                                 pad=False)
    mix = GaussianMixture(mix.positions, mix.scalings, mix.rotations,
                          jnp.asarray(0.3 * r.randn(n, 3), jnp.float32),
                          mix.alive)
    dens = r.rand(12, 12, 12).astype(np.float32)
    case = {"spec": dict(spec.__dict__),
            "mix": {k: np.asarray(getattr(mix, k)) for k in
                    ("positions", "scalings", "rotations", "values",
                     "alive")},
            "density": dens, "domain": (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0),
            "dt": 0.05, "grid": (12, 12, 12), "chunk": 512}
    return case, mix, spec


@pytest.fixture(scope="module")
def density_runs(density_case):
    got = {}

    def at(shape):
        if shape not in got:
            got[shape] = _launch(ranks.density_rank, shape, density_case[0])
        return got[shape]
    return at


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_density_step_matches_single_device(shape, density_case,
                                            density_runs):
    want = ranks.single_density(density_case[0])
    for got in density_runs(shape):
        assert got.shape == (12, 12, 12)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_density_step_matches_jax_sharded(shape, density_case, density_runs,
                                          monkeypatch):
    monkeypatch.setenv("GF_FIELD_BACKEND", "dense")
    case, mix, spec = density_case
    jdensity.make_sharded_density_step.cache_clear()
    want = np.asarray(jdensity.advected_density_sharded(
        jnp.asarray(case["density"]), mix, spec, case["domain"], case["dt"],
        case["grid"], jsh.make_mesh(4, 2), chunk=case["chunk"]))
    jdensity.make_sharded_density_step.cache_clear()
    np.testing.assert_allclose(density_runs(shape)[0], want, rtol=1e-5,
                               atol=1e-6)


# ---- the host loops end to end ----

@pytest.fixture(scope="module")
def phases_case():
    """tests/test_parallel.py's clone end-to-end state: 96 Gaussians in
    the leapfrog box, a quarter stretched past the split ratio."""
    from gaussian_fluids_torch.scenes import get_scene_2d
    scene = get_scene_2d("leapfrog")
    sf = scene.scaling_factor
    adv = np.asarray(scene.advance_domain, np.float32)
    lo, hi = np.asarray([adv[0], adv[2]]) * sf, np.asarray([adv[1],
                                                            adv[3]]) * sf
    n = 96
    spec = TSpec.create(tuple(lo), tuple(hi), n, d=2, vdim=2)
    r = np.random.RandomState(17)
    m = TMix.create(r.uniform(lo * 0.8, hi * 0.8, (n, 2)), spec,
                    device="cpu").compact()
    m.scalings[: n // 4, 0] += np.log(2.0)
    m.values = torch.as_tensor((0.1 * r.randn(n, 2)).astype(np.float32))
    xs = np.linspace(lo[0], hi[0], 10)
    ys = np.linspace(lo[1], hi[1], 10)
    return {"spec": dict(spec.__dict__), "scene": "leapfrog",
            "mix": {k: getattr(m, k).numpy() for k in
                    ("positions", "scalings", "rotations", "values",
                     "alive")},
            "test_x": np.stack(np.meshgrid(xs, ys, indexing="xy"),
                               -1).reshape(-1, 2).astype(np.float32),
            "seed": 1, "batch": 64, "epochs": 100, "check_iter": 50,
            "dt": 0.025}


def test_clone_and_projection_host_loops_end_to_end(phases_case):
    """``clone_velocity_field_sharded`` splits as the single-device clone
    does (the same numpy draws: two children per stretched parent) and
    re-fits toward the old field (mean |u - u_old| < 0.05 on the test
    grid, the JAX package's bound), and ``project_2d_sharded`` then runs
    two chunks without growing the test losses by more than 5%; finite
    metrics throughout; every rank returns the same mixtures."""
    c = phases_case
    out = _launch(ranks.phases_rank, (2, 2), c)
    for o in out[1:]:
        for phase in ("clone", "project"):
            for k, v in out[0][phase].items():
                np.testing.assert_array_equal(o[phase][k], v)
    res = out[0]
    spec = ranks.spec_of(c)
    old = ranks.mix_of(c["mix"])
    n = int(c["mix"]["alive"].sum())
    single, _, n_split = tclone.split_gaussians_2d(
        old, spec, np.random.RandomState(c["seed"]))
    assert n_split == n // 4
    assert int(res["clone"]["alive"].sum()) == n + n // 4 == \
        single.n_alive()
    np.testing.assert_array_equal(res["clone"]["alive"],
                                  single.alive.numpy())

    def mix(d):
        return mixture_of({k: torch.as_tensor(v) for k, v in d.items()
                           if k != "alive"}, torch.as_tensor(d["alive"]))
    x = torch.as_tensor(c["test_x"])
    with torch.no_grad():
        v_old = tfield.value(old, spec, x)
        v_new = tfield.value(mix(res["clone"]), spec, x)
    err = float((v_new - v_old).abs().mean())
    assert np.isfinite(err) and err < 0.05, err
    for m in (res["clone_metrics"], res["project_metrics"]):
        assert m and all(np.isfinite(v) for v in m.values()), m
    with torch.no_grad():
        _, j0 = tfield.value_and_jac(mix(res["clone"]), spec, x)
        _, j1 = tfield.value_and_jac(mix(res["project"]), spec, x)
    d0 = float((losses.divergence(j0) ** 2).mean())
    d1 = float((losses.divergence(j1) ** 2).mean())
    assert d1 <= d0 * 1.05, (d0, d1)


def test_dryrun():
    out = tsh.dryrun(4)
    assert all(np.isfinite(v) for v in out["project_losses"])
    assert np.isfinite(out["fit_loss"]) and np.isfinite(out["density_mean"])
