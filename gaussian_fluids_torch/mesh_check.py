"""The multi-device paths against the single-device ones, on cards.

    python -m gaussian_fluids_torch.mesh_check [--mesh 2x2 --mesh 4x1 ...]

Runs the checks the smoke run makes on one card (``chip_smoke.py``'s
``mesh_epoch``, ``mesh_density`` and ``mesh_cli``) on as many GPUs as the
meshes hold, over NCCL, one rank per GPU:
  * epochs: one sharded projection and one sharded clone epoch at
    Leapfrog-2D width (seeded state, 5041 Gaussians, capacity 6144,
    B = 512) and Ring-Collide width (64,000, capacity 75,776, B = 8192)
    from the same seeded inputs, against the single-device epochs on
    cuda:0 (losses, gradients as Adam's first moments, parameters; every
    rank's parameters equal), then MESH_TIMED_EPOCHS timed; every layout
    given runs in one launch (``parallel.mesh.reshape``);
  * density: the sharded 128^3 density step on the seeded Ring-Collide
    state, slab-major, against the single-device step;
  * cli: a Leapfrog-2D fit (FIT_EPOCHS) and one frame (FRAME_EPOCHS a
    phase) through ``advance2d`` on cuda:0, then the frame at each
    ``--mesh`` (the same Gaussian count, the field within
    MESH_FIELD_TOL); a Ring-Collide fit through ``initialize3d``, one
    128^3 replay step through ``advance_density3d`` on cuda:0 and at each
    ``--mesh`` (within DENSITY_TOL).
Prints one JSON line per check, then the card's name and power limit;
any disagreement raises. The layouts of one call hold the same number of
ranks (the default: 2x2, 4x1, 1x4 on four GPUs).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MESH_TIMED_EPOCHS = 2   # timed after the compared epoch, from its state
MESH_LOSS_RTOL = 1e-4   # sharded against single-device losses (f32 sums
#                         reassociated over the shards)
MESH_GRAD_TOL = 1e-3    # gradients, of each group's largest entry: L1
#                         heads flip sign on rows within f32 of their
#                         target; a G-times gradient misses by 1.0
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 2e-4, 1e-6  # after one warm Adam step,
#                         as the JAX package's sharded tests hold them
MESH_FIELD_TOL = 0.05   # a mesh frame's field against the single-device
#                         frame's, of the field's mean |u| (other draws)
DENSITY_TOL = 2e-3      # a sampled density, as the smoke's check_density
DENSITY_DT = 0.02
RANK_TIMEOUT = 900      # seconds: a hung collective fails the check
FIT_EPOCHS = FRAME_EPOCHS = 100


def emit(obj):
    # one write a line: lines from the smoke's threads never interleave
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def all_launches():
    from gaussian_fluids_torch.ops import (gsr_banded, gsr_cells,
                                           gsr_centered, rk4_fused)
    return {**gsr_centered.launches, **gsr_cells.launches,
            **gsr_banded.launches, **rk4_fused.launches}


def reset_all_launches():
    from gaussian_fluids_torch.ops import (gsr_banded, gsr_cells,
                                           gsr_centered, rk4_fused)
    for m in (gsr_centered, gsr_cells, gsr_banded, rk4_fused):
        m.reset_launches()


def _launched():
    return {k: v for k, v in all_launches().items() if v}


def _warm_opt(params, lrs):
    """Adam state with a nonzero second moment, as after earlier epochs:
    its step is then linear in the gradient, so f32 differences in
    near-zero gradients stay f32-sized in the parameters."""
    from gaussian_fluids_torch.solver import optim
    st = optim.init(params, lrs, patience=50)
    return st._replace(groups={k: g._replace(v=torch.full_like(g.v, 1e-2))
                               for k, g in st.groups.items()})


def configs(device):
    """The epochs' inputs, the same in every process: per configuration
    the mixture, an old mixture of another seed (the clone's and the
    projection's targets), a projection batch with its boundary rows, a
    clone batch and freeze mask."""
    from gaussian_fluids_torch.scenes import get_scene_2d, get_scene_3d
    from gaussian_fluids_torch.solver import clone, project
    from gaussian_fluids_torch.utils.seeded_state import (leapfrog_state,
                                                          ring_collide_state)
    rng = np.random.RandomState(21)
    gen = torch.Generator(device=device).manual_seed(22)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    mix, spec, _ = leapfrog_state(device, seed=0)
    scene = get_scene_2d("leapfrog")
    adv = torch.tensor(scene.advance_domain, dtype=torch.float32,
                       device=device)
    lf = {"mix": mix, "old": leapfrog_state(device, seed=1)[0],
          "spec": spec, "dim": 2, "batch": 512, "scene": "leapfrog",
          "adv": adv, "dt": 0.025, "lam": 1.0,
          "weights": project.ProjectWeights(),
          "data": t(rng.uniform(-5, 5, (512, 2))),
          "b2": scene.boundary_sampler_2(gen, 512, adv),
          "x": t(rng.uniform(-5, 5, (512, 2))),
          "stop": torch.as_tensor(rng.rand(mix.capacity) < 0.5,
                                  device=device),
          "lrs_project": project.DEFAULT_LRS_2D,
          "lrs_clone": clone.DEFAULT_LRS_CLONE_2D}
    mix, spec, _ = ring_collide_state(device, seed=0)
    rc = {"mix": mix, "old": ring_collide_state(device, seed=1)[0],
          "spec": spec, "dim": 3, "batch": 8192, "scene": "ring_collide",
          "dt": 0.02, "lam": 10.0,
          "weights": project.ProjectWeights(delta_pos=0.0),
          "data": t(rng.uniform(0, 1, (8192, 3))),
          "bnd": get_scene_3d("ring_collide").boundary_sampler(gen, 8192),
          "x": t(rng.uniform(0, 1, (8192, 3))),
          "stop": torch.as_tensor(rng.rand(mix.capacity) < 0.5,
                                  device=device),
          "lrs_project": project.DEFAULT_LRS_3D,
          "lrs_clone": clone.DEFAULT_LRS_CLONE_3D}
    return {"leapfrog_2d": lf, "ring_collide": rc}


def single_epoch(c, kind):
    """``run() -> (params, opt_state, losses)``: the port's single-device
    projection or clone epoch on the configuration's inputs, from the same
    state at every call."""
    from gaussian_fluids_torch.solver import clone, project
    p, alive, spec = c["mix"].params(), c["mix"].alive, c["spec"]
    opt = _warm_opt(p, c["lrs_" + kind])
    if kind == "clone":
        epoch = clone._clone_runner(spec, c["batch"], spec.lo,
                                    spec.hi).epoch
        carry, xs = (p, opt, alive, c["stop"], c["old"]), c["x"]
    elif c["dim"] == 2:
        epoch = project._runner_2d(spec, c["scene"], c["weights"], c["lam"],
                                   c["batch"]).epoch
        carry = (p, opt, alive, c["mix"].positions, c["old"], c["adv"],
                 c["dt"])
        xs = (c["data"], None, None, c["b2"])
    else:
        epoch = project._runner_3d(spec, c["scene"], c["weights"], c["lam"],
                                   c["batch"], (0.0,) * 3, (1.0,) * 3).epoch
        carry = (p, opt, alive, c["old"], c["dt"])
        xs = (c["data"], None, None, c["bnd"])

    def run():
        (params, o, *_), ls = epoch(carry, xs)
        return params, o, ls
    return run


def sharded_epoch(c, kind, mesh):
    """The same epoch sharded over ``mesh``, from this rank's shards."""
    from gaussian_fluids_torch.parallel import sharding
    p, alive, spec = c["mix"].params(), c["mix"].alive, c["spec"]
    opt = _warm_opt(p, c["lrs_" + kind])
    if kind == "clone":
        step, place = sharding.make_sharded_clone_step(spec, mesh)
        args = place(p, opt, alive, c["stop"], c["old"]) + (c["x"],)
    elif c["dim"] == 2:
        step, place = sharding.make_sharded_project_step_2d(
            spec, mesh, c["scene"], c["lam"], c["weights"])
        args = place(p, opt, alive, c["mix"].positions, c["old"]) + (
            c["adv"], c["dt"], c["data"], None, c["b2"])
    else:
        step, place = sharding.make_sharded_project_step_3d(
            spec, mesh, c["lam"], c["weights"])
        args = place(p, opt, alive, c["old"]) + (c["dt"], c["data"],
                                                 c["bnd"])
    return lambda: step(*args)


def timed(run):
    """(first call's output, its wall ms, the median wall ms of the next
    MESH_TIMED_EPOCHS calls), each synchronised."""
    def once():
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)
    first, first_ms = once()
    return first, first_ms, statistics.median(
        once()[1] for _ in range(MESH_TIMED_EPOCHS))


def _host(params, opt_state, ls):
    return {"params": {k: v.detach().cpu() for k, v in params.items()},
            "m": {k: g.m.detach().cpu() for k, g in opt_state.groups.items()},
            "losses": ls.detach().cpu().reshape(-1)}


def _probe(mesh):
    """all_reduce and broadcast, the port's two collectives, on this
    rank's device: their results."""
    import torch.distributed as dist
    t = torch.full((4,), float(mesh.rank + 1), device=mesh.device)
    dist.all_reduce(t)
    b = torch.full((4,), float(mesh.rank + 1), device=mesh.device)
    dist.broadcast(b, src=1)
    return {"all_reduce": t.tolist(), "broadcast": b.tolist()}


def density_input(device, ckpt=None):
    """(mixture, slab-major, its spec, the seeded ring-1 density at 128^3,
    the scene's domain): of the Ring-Collide checkpoint ``ckpt``, or of
    the seeded Ring-Collide state."""
    from gaussian_fluids_torch.io import checkpoint
    from gaussian_fluids_torch.ops import interp
    from gaussian_fluids_torch.scenes import get_scene_3d
    from gaussian_fluids_torch.utils.seeded_state import ring_collide_state
    scene = get_scene_3d("ring_collide")
    if ckpt is None:
        mix, spec, _ = ring_collide_state(device)
    else:
        mix, spec = checkpoint.load_checkpoint(ckpt, device=device)
    r = scene.info["ring1"]
    dens = interp.seed_ring_density((128,) * 3, scene.domain, r.center,
                                    r.normal, r.radius, r.thickness,
                                    device=device)
    return mix.slab_sorted(spec.clamp_threshold), spec, dens, scene.domain


def rank_check(mesh, layouts, ckpt):
    """One rank's work at each layout of ``layouts`` ({layout: results}):
    the probe; per configuration and epoch kind one sharded epoch
    (compared by the launcher) and MESH_TIMED_EPOCHS timed, with this
    rank's launches by kernel; the sharded 128^3 density step twice (the
    second warm), with its launches."""
    from gaussian_fluids_torch.parallel import collectives, sharding
    from gaussian_fluids_torch.parallel.density import \
        advected_density_sharded
    from gaussian_fluids_torch.parallel.mesh import reshape

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for layout in layouts:
        m = reshape(mesh, layout)
        res = {"probe": _probe(m)}
        for name, c in configs(m.device).items():
            for kind in ("project", "clone"):
                reset_all_launches()
                (params, opt, ls), first_ms, ms = timed(
                    sharded_epoch(c, kind, m))
                opt = opt._replace(groups={
                    k: g._replace(m=collectives.gather_rows(g.m, m))
                    for k, g in opt.groups.items()})
                res[f"{name}/{kind}"] = {
                    **_host(sharding.gather_params(params, m), opt, ls),
                    "first_ms": first_ms, "wall_ms": ms,
                    "launches": _launched()}
        mix, spec, dens, domain = density_input(m.device, ckpt)
        reset_all_launches()
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            vol = advected_density_sharded(dens, mix, spec, domain,
                                           DENSITY_DT, (128,) * 3, m)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        res["density"] = {"seconds": secs, "launches": _launched(),
                          "volume": vol.cpu() if m.rank == 0 else None}
        out[layout] = res
    return out


def compare(got, want):
    """Losses, gradients (Adam's first moments) and parameters of a
    sharded epoch against the single-device epoch's: the largest
    differences; raises past a tolerance."""
    rep = {"losses_max_rel_diff": float(
        ((got["losses"] - want["losses"]).abs()
         / want["losses"].abs().clamp(min=1e-7)).max())}
    rep["grads_max_diff_of_largest"] = max(
        float((got["m"][k] - want["m"][k]).abs().max()
              / want["m"][k].abs().max().clamp(min=1e-30))
        for k in want["m"])
    rep["params_max_abs_diff"] = max(
        float((got["params"][k] - want["params"][k]).abs().max())
        for k in want["params"])
    ok = rep["losses_max_rel_diff"] <= MESH_LOSS_RTOL \
        and rep["grads_max_diff_of_largest"] <= MESH_GRAD_TOL \
        and all(torch.allclose(got["params"][k], want["params"][k],
                               rtol=MESH_PARAM_RTOL, atol=MESH_PARAM_ATOL)
                for k in want["params"])
    if not ok:
        raise AssertionError(f"sharded epoch off the single-device one: "
                             f"{rep}")
    return rep


def launch_ranks(layouts, device, ckpt=None, shared=False):
    """One launch of the layouts' ranks (NCCL, one GPU a rank; or
    ``shared``: gloo, every rank on ``device``) running every layout
    (:func:`rank_check`): (what each rank returned, the launch's wall
    seconds). The launching process launches no kernel, so this may run
    beside other work."""
    from gaussian_fluids_torch.parallel.mesh import launch
    t0 = time.perf_counter()
    by_rank = launch(rank_check, layouts[0], (tuple(layouts), ckpt),
                     device=device, shared_device=shared,
                     timeout=RANK_TIMEOUT)
    return by_rank, time.perf_counter() - t0


def check_epochs(layouts, device, card, ckpt=None, shared=False,
                 ranks=None):
    """The epochs and density checks: the single-device references on
    ``device`` against the ranks' results, ``ranks`` (of a
    :func:`launch_ranks` made beforehand) or one launch made here. Emits
    one ``mesh_epoch`` and one ``mesh_density`` line a layout; returns
    the ranks' launches by kernel, summed over ranks and layouts, per path
    ({"leapfrog_2d", "ring_collide", "density"})."""
    from gaussian_fluids_torch.solver.simulate3d import advected_density

    single = {}
    for name, c in configs(device).items():
        for kind in ("project", "clone"):
            reset_all_launches()
            out, first_ms, ms = timed(single_epoch(c, kind))
            single[f"{name}/{kind}"] = {
                **_host(*out), "first_ms": first_ms, "wall_ms": ms,
                "launches": _launched()}
    mix, spec, dens, domain = density_input(device, ckpt)
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        want_vol = advected_density(dens, mix, spec, domain, DENSITY_DT,
                                    (128,) * 3)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    want_vol = want_vol.cpu()

    totals = {"leapfrog_2d": {}, "ring_collide": {}, "density": {}}

    def add(path, launches):
        for k, v in launches.items():
            totals[path][k] = totals[path].get(k, 0) + v

    by_rank, wall = ranks or launch_ranks(layouts, device, ckpt, shared)
    backend = (f"gloo, every rank on {device}" if shared else
               "nccl, one GPU a rank")
    for layout in layouts:
        ranks = [r[layout] for r in by_rank]
        n = len(ranks)
        probe = ranks[0]["probe"]
        if probe != {"all_reduce": [n * (n + 1) / 2] * 4,
                     "broadcast": [2.0] * 4}:
            raise AssertionError(f"{backend}: collectives gave {probe}")
        epochs = {}
        for key in single:
            rep = compare(ranks[0][key], single[key])
            for rk in ranks:
                for k, v in ranks[0][key]["params"].items():
                    if not torch.equal(rk[key]["params"][k], v):
                        raise AssertionError(f"{key}: ranks disagree on {k}")
                if not rk[key]["launches"]:
                    raise AssertionError(f"{key}: a rank launched nothing")
                add(key.split("/")[0], rk[key]["launches"])
            epochs[key] = {
                **rep, "wall_ms": [rk[key]["wall_ms"] for rk in ranks],
                "first_ms": [rk[key]["first_ms"] for rk in ranks],
                "single_wall_ms": single[key]["wall_ms"],
                "single_first_ms": single[key]["first_ms"],
                "launches_by_rank": [rk[key]["launches"] for rk in ranks],
                "single_launches": single[key]["launches"]}
        emit({"phase": "mesh_epoch", "mesh": list(layout),
              "backend": backend, "card": card,
              "launch_seconds_all_layouts": wall, "probe": probe,
              "tolerances": {"loss_rtol": MESH_LOSS_RTOL,
                             "grad_of_largest": MESH_GRAD_TOL,
                             "param_rtol": MESH_PARAM_RTOL,
                             "param_atol": MESH_PARAM_ATOL},
              "epochs": epochs})
        vol = ranks[0]["density"]["volume"]
        diff = float((vol - want_vol).abs().max())
        if not torch.isfinite(vol).all() or diff > DENSITY_TOL:
            raise AssertionError(f"sharded density step {layout}: max "
                                 f"|diff| {diff}")
        for rk in ranks:
            if not rk["density"]["launches"].get("gsr_value_banded"):
                raise AssertionError("a density rank skipped the banded "
                                     "kernel")
            add("density", rk["density"]["launches"])
        emit({"phase": "mesh_density", "mesh": list(layout),
              "backend": backend, "card": card, "grid": [128] * 3,
              "state": ckpt or "seeded Ring-Collide", "dt": DENSITY_DT,
              "max_abs_diff": diff, "tolerance": DENSITY_TOL,
              "seconds_by_rank": [rk["density"]["seconds"] for rk in ranks],
              "single_seconds": secs,
              "launches_by_rank": [rk["density"]["launches"]
                                   for rk in ranks]})
    return totals


def cli_frame_run(start, out_dir, mesh, epochs):
    """One Leapfrog-2D frame through ``advance2d --mesh mesh`` from the
    checkpoint ``start``: (its frames, wall seconds). The launching
    process launches no kernel, so this may run beside other work."""
    from gaussian_fluids_torch import advance2d

    os.makedirs(out_dir)
    shutil.copy(start, os.path.join(out_dir, "gaussian_velocity_0.pt"))
    t0 = time.perf_counter()
    _, _, frames = advance2d.main(
        ["--init_cond", "leapfrog", "--dir", out_dir, "--dt", ".025",
         "--last_time", ".025", "--max_epoch", str(epochs), "--mesh",
         mesh, "--no_viz"])
    return frames, time.perf_counter() - t0


def cli_frame(start, single, out_dir, mesh, card, epochs, ran=None):
    """The frame of :func:`cli_frame_run` (``ran``, or run here) against
    the single-device frame ``single``: finite test metrics, one
    checkpoint a frame, the same Gaussian count, the field within
    MESH_FIELD_TOL."""
    from gaussian_fluids_torch.io import checkpoint
    from gaussian_fluids_torch.ops import field

    frames, wall = ran or cli_frame_run(start, out_dir, mesh, epochs)
    f = frames[0]
    vals = list(f["clone"].values()) + list(f["project"].values())
    if len(frames) != 1 or not f["project"] or \
            not np.isfinite(vals).all():
        raise AssertionError(f"--mesh {mesh} frames: {frames}")
    if sorted(os.listdir(out_dir)) != [f"gaussian_velocity_{i}.pt"
                                       for i in range(2)]:
        raise AssertionError(f"--mesh {mesh}: {os.listdir(out_dir)}")
    want, spec = checkpoint.load_checkpoint(single)
    got, _ = checkpoint.load_checkpoint(
        os.path.join(out_dir, "gaussian_velocity_1.pt"))
    x = torch.as_tensor(np.random.RandomState(4).uniform(
        -4.5, 4.5, (4096, 2)).astype(np.float32), device=got.device)
    with torch.no_grad():
        v_want = field.value(want, spec, x)
        err = float((field.value(got, spec, x) - v_want).abs().mean()
                    / v_want.abs().mean())
    if got.n_alive() != want.n_alive() or err > MESH_FIELD_TOL:
        raise AssertionError(f"--mesh {mesh} frame: N {got.n_alive()} vs "
                             f"{want.n_alive()}, field {err}")
    emit({"phase": "mesh_cli", "entry": "advance2d", "mesh": mesh,
          "card": card, "seconds": wall, "frame_seconds": f["seconds"],
          "clone": f["clone"], "project": f["project"],
          "n_gaussians": got.n_alive(), "field_rel_diff": err,
          "tolerance": MESH_FIELD_TOL})


def cli_replay(start, single_dir, out_dir, mesh, card):
    """One 128^3 replay step of the Ring-Collide checkpoint ``start``
    through ``advance_density3d --mesh mesh`` against the single-device
    step's volumes in ``single_dir`` (within DENSITY_TOL). The launching
    process launches no kernel, so this may run beside other work."""
    from gaussian_fluids_torch import advance_density3d
    from gaussian_fluids_torch.io import vti

    os.makedirs(out_dir)
    shutil.copy(start, os.path.join(out_dir, "gaussian_velocity_0.pt"))
    t0 = time.perf_counter()
    records = advance_density3d.main(
        ["--init_cond", "ring_collide", "--dir", out_dir, "--dt",
         str(DENSITY_DT), "--density_res_multiplier", "1", "--mesh", mesh])
    wall = time.perf_counter() - t0
    diffs = {}
    for tag in "ab":
        a = vti.read_vti_array(os.path.join(out_dir,
                                            f"density_{tag}_1.vti"))
        b = vti.read_vti_array(os.path.join(single_dir,
                                            f"density_{tag}_1.vti"))
        diffs[tag] = float(np.abs(a - b).max())
        if not np.isfinite(a).all() or diffs[tag] > DENSITY_TOL:
            raise AssertionError(f"--mesh {mesh} density {tag}: "
                                 f"{diffs[tag]}")
    emit({"phase": "mesh_cli", "entry": "advance_density3d", "mesh": mesh,
          "card": card, "seconds": wall, "grid": [128] * 3,
          "step_seconds": records[0]["seconds"], "max_abs_diff": diffs,
          "tolerance": DENSITY_TOL})


def failing_rank(mesh):
    """Rank 1 raises while rank 0 waits in a broadcast from it: the launch
    must raise rank 1's own error (the smoke's ``mesh_error``)."""
    from gaussian_fluids_torch.parallel import collectives
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed")
    collectives.broadcast(torch.zeros(1, device=mesh.device), mesh, src=1)


def mesh_error(device, launches=3):
    """``launches`` launches of :func:`failing_rank` on two ranks sharing
    ``device`` over gloo, side by side from as many threads: how many
    raised rank 1's own error (all must)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch.multiprocessing as tmp

    from gaussian_fluids_torch.parallel.mesh import launch

    def one(_):
        try:
            launch(failing_rank, (1, 2), device=device, shared_device=True,
                   timeout=300)
        except tmp.ProcessRaisedException as e:
            return "rank 1 failed" in str(e) and "RuntimeError" in str(e)
        return False

    with ThreadPoolExecutor(launches) as pool:
        return sum(pool.map(one, range(launches)))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    from gaussian_fluids_torch import (advance2d, advance_density3d,
                                       initialize2d, initialize3d)
    from gaussian_fluids_torch.cli import parse_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", action="append",
                    help="a BxG layout; repeat for more (one size)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_check: needs CUDA GPUs")
    layouts = [parse_mesh(m) for m in
               (args.mesh or ["2x2", "4x1", "1x4"])]
    if len({b * g for b, g in layouts}) != 1:
        raise SystemExit("mesh_check: the layouts must hold one number "
                         "of ranks")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    card = card_line()
    check_epochs(layouts, device, card)
    tmp = tempfile.mkdtemp(prefix="gf_mesh_check_")
    try:
        fit2, fit3 = os.path.join(tmp, "lf"), os.path.join(tmp, "rc")
        initialize2d.main(["--init_cond", "leapfrog", "--dir", fit2,
                           "--max_epoch", str(FIT_EPOCHS), "--no_viz"])
        start2 = os.path.join(tmp, "lf_start.pt")
        shutil.copy(os.path.join(fit2, "gaussian_velocity_0.pt"), start2)
        advance2d.main(["--init_cond", "leapfrog", "--dir", fit2, "--dt",
                        ".025", "--last_time", ".025", "--max_epoch",
                        str(FRAME_EPOCHS), "--no_viz"])
        initialize3d.main(["--init_cond", "ring_collide", "--dir", fit3,
                           "--max_epoch", str(FIT_EPOCHS), "--no_viz"])
        advance_density3d.main(["--init_cond", "ring_collide", "--dir",
                                fit3, "--dt", str(DENSITY_DT),
                                "--density_res_multiplier", "1"])
        for b, g in layouts:
            mesh = f"{b}x{g}"
            cli_frame(start2, os.path.join(fit2, "gaussian_velocity_1.pt"),
                      os.path.join(tmp, f"lf_{mesh}"), mesh, card,
                      FRAME_EPOCHS)
            cli_replay(os.path.join(fit3, "gaussian_velocity_0.pt"), fit3,
                       os.path.join(tmp, f"rc_{mesh}"), mesh, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
