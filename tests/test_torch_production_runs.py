"""The port's first production runs on the card, held to their gates
against the committed JAX runs (``runs_port_evidence/``, written by
``gaussian_fluids_torch.scripts.production`` on an NVIDIA H100; PERF.md
"Production runs").

The committed port checkpoints run through the port's analyzers here on
the CPU, the JAX run's frames through the same analyzers, and the tables
the card printed are read where the CPU cannot afford the run (the 512^3
replay's volumes are not committed):

* A, Ring-Collide frames 1-8 from the JAX frame 0: mean|div| at most
  1.25x the JAX run's and r_ring within 0.02 of it at frames 4 and 8,
  the wall flux at most 0.001, every projection stopped by patience;
* B, its 512^3 replay: mass/mass0 and the centre of mass within 0.01 of
  the JAX rows; the pooled densities of frame 1, which only the shared
  frame 0 advects, within the smoke's replay tolerance (1e-2) of the JAX
  replay's;
* C, Taylor-vortex frames 1-20 from the JAX frame 0: at frames 10 and 20
  mean|div| at most 1.25x, core separation within 0.05, angle within 3
  degrees and N within 20% of the JAX frames';
* D, Taylor-Green (the frames the runs reached of 200): the mean L1
  velocity error against the closed form at most 0.0027 (frame 100's
  bound) at every frame; each projection's test ``loss_div`` (the mean
  squared divergence on the solver's test grid: BASELINE.md's 9.0e-5 at
  frame 1) at most 1.8e-4; the analyzer's mean|div| on its 160^2 grid,
  a different quantity (4.35e-3 on the JAX package's own fit), at most
  1.25x the JAX package's fit and frame 1; the JAX package's analyzer
  prints the same table on the same checkpoints.
"""

import os
import re

import numpy as np
import pytest

from gaussian_fluids_torch.scripts import report_runs

from test_torch_analyzers import _jax_output, _port_output, _unit, \
    assert_same_numbers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EV = os.path.join(REPO, "runs_port_evidence")
JAX_EV = os.path.join(REPO, "runs_r2_evidence")
JAX_TV = os.path.join(JAX_EV, "ckpts", "output_tv")

RC_DIV_RATIO = 1.25     # mean|div| against the JAX run's, A and C
RC_R_RING = 0.02
RC_WALL_FLUX = 0.001
DENSITY_TOL = 0.01      # mass/mass0 and each centre-of-mass coordinate
TV_SEP = 0.05
TV_ANGLE = 3.0          # degrees, on the orientation's [0, 180) circle
TV_N = 0.20
TG_L1 = 0.0027          # frame 100's: twice the JAX run's 0.00135
TG_LOSS_DIV = 1.8e-4    # twice the JAX run's loss_div at frame 1
TG_GRID_DIV = 1.25      # the analyzer's mean|div| against the JAX fit's


def _rows(text):
    """{frame: [tokens]} of an analyzer table's numeric rows."""
    out = {}
    for ln in text.splitlines():
        t = ln.replace("|", " ").split()
        if t and t[0].isdigit():
            out[int(t[0])] = t
    return out


def _read(*parts):
    with open(os.path.join(*parts)) as fh:
        return fh.read()


# A: Ring-Collide

def _jax_rc_rows():
    """The JAX exact run's frames in the committed A/B table:
    {frame: (mean|div|, r_ring, wall flux)}."""
    rows = _rows(_read(JAX_EV, "analyze_rc_tg128_ab.txt"))
    return {n: (float(t[1]), float(t[6]), float(t[8]))
            for n, t in rows.items()}


@pytest.fixture(scope="module")
def rc_cpu():
    text = _port_output("analyze_ring3d",
                        [os.path.join(EV, "ring_collide"), "4", "32"])
    return _rows(text)


def test_ring_collide_frames_meet_the_jax_run(rc_cpu):
    jax = _jax_rc_rows()
    assert sorted(rc_cpu) == [4, 8]
    for n, t in rc_cpu.items():
        div, r_ring, flux = float(t[2]), float(t[5]), float(t[7])
        assert int(t[1]) == 64000
        assert div <= RC_DIV_RATIO * jax[n][0], (n, div, jax[n])
        assert abs(r_ring - jax[n][1]) <= RC_R_RING, (n, r_ring, jax[n])
        assert flux <= RC_WALL_FLUX, (n, flux)


def test_ring_collide_card_table_passes_and_matches_the_cpu(rc_cpu):
    text = _read(EV, "ring_collide", "analyze_rc_tg128_ab.txt")
    assert "# VERDICT: PASS" in text
    card = _rows(text)
    assert sorted(card) == [0, 4, 8]
    jax = _jax_rc_rows()
    for n, t in card.items():
        # the JAX column is the committed JAX table's, to the digit
        assert (float(t[1]), float(t[6]), float(t[8])) == jax[n]
        if n in rc_cpu:
            # the card's port column against the CPU's evaluation
            for card_tok, cpu_tok in ((t[2], rc_cpu[n][2]),
                                      (t[7], rc_cpu[n][5]),
                                      (t[9], rc_cpu[n][7])):
                assert abs(float(card_tok) - float(cpu_tok)) \
                    <= 1.0001 * _unit(card_tok), (n, card_tok, cpu_tok)


def _frames(*parts):
    return report_runs.frame_records(os.path.join(EV, *parts))


def _stopped_by_patience(recs):
    for r in recs:
        for phase in ("clone_epochs", "project_epochs"):
            if r[phase] is not None:
                epochs, stopped = r[phase]
                assert stopped and epochs < 20000, (r["frame"], phase, epochs)


def test_ring_collide_projections_stop_by_patience():
    recs = _frames("ring_collide", "rc_advance.frames.txt")
    assert [r["frame"] for r in recs] == list(range(1, 9))
    assert all(r["project_epochs"] for r in recs)
    _stopped_by_patience(recs)


# B: the replay

def _density_rows(text):
    """{(tag, frame): (mass/mass0, (x, y, z))} of analyze_density3d."""
    out, tag = {}, None
    for ln in text.splitlines():
        m = re.match(r"== density '(\w)'", ln)
        if m:
            tag = m.group(1)
            continue
        t = ln.split()
        if tag and t and t[0].isdigit():
            com = tuple(float(c) for c in t[4].strip("()").split(","))
            out[(tag, int(t[0]))] = (float(t[1]), com)
    return out


def test_density_replay_meets_the_jax_rows():
    port = _density_rows(_read(EV, "ring_collide_density",
                               "analyze_density3d.txt"))
    jax = _density_rows(_read(JAX_EV, "analyze_density3d_rc.txt"))
    keys = sorted(port)
    assert {k[0] for k in keys} == {"a", "b"}
    assert all((tag, n) in port for tag in "ab" for n in range(9))
    for k in keys:
        mass, com = port[k]
        assert abs(mass - jax[k][0]) <= DENSITY_TOL, (k, port[k], jax[k])
        assert max(abs(a - b) for a, b in zip(com, jax[k][1])) \
            <= DENSITY_TOL, (k, port[k], jax[k])


def test_density_replay_frame_1_matches_the_jax_replay():
    jax_dir = os.path.join(JAX_EV, "ckpts", "output_3d_ring_collide")
    for tag in "ab":
        got, want = (np.load(os.path.join(d, f"density_small_{tag}_1.npz"))
                     ["density"].astype(np.float64)
                     for d in (os.path.join(EV, "ring_collide_density"),
                               jax_dir))
        assert np.abs(got - want).max() <= 1e-2
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


# C: Taylor-vortex

@pytest.fixture(scope="module")
def tv_tables(tmp_path_factory):
    jax_dir = tmp_path_factory.mktemp("tv_jax")
    for n in (10, 20):
        os.symlink(os.path.join(JAX_TV, f"gaussian_velocity_{n}.pt"),
                   jax_dir / f"gaussian_velocity_{n}.pt")
    return tuple(_rows(_port_output("analyze_taylor_vortex2d", [d, "10"]))
                 for d in (os.path.join(EV, "taylor_vortex"), str(jax_dir)))


def test_taylor_vortex_projections_stop_by_patience():
    recs = _frames("taylor_vortex", "tv_advance.frames.txt")
    assert [r["frame"] for r in recs] == list(range(1, 21))
    _stopped_by_patience(recs)


def test_taylor_vortex_frames_meet_the_jax_frames(tv_tables):
    port, jax = tv_tables
    assert sorted(port) == sorted(jax) == [10, 20]
    for n in (10, 20):
        p, j = port[n], jax[n]
        assert abs(int(p[1]) - int(j[1])) <= TV_N * int(j[1]), (p, j)
        assert float(p[2]) <= RC_DIV_RATIO * float(j[2]), (p, j)
        assert abs(float(p[7]) - float(j[7])) <= TV_SEP, (p, j)
        d = abs(float(p[8]) - float(j[8])) % 180.0
        assert min(d, 180.0 - d) <= TV_ANGLE, (p, j)


# D: Taylor-Green

def _tg(text):
    speed = float(re.search(r"analytic mean\|u\| = ([\d.]+)",
                            text).group(1))
    return speed, _rows(text)


def test_taylor_green_projections_meet_the_baseline_divergence():
    """Every frame's projection stops by patience with its test
    ``loss_div`` (the mean squared divergence on the solver's test grid,
    the quantity BASELINE.md measured) at most twice the JAX run's."""
    recs = _frames("taylor_green", "tg_advance.frames.txt")
    frames = [r["frame"] for r in recs]
    # one run cut by a call's end and resumed in the next: no gap
    assert frames == list(range(1, frames[-1] + 1))
    _stopped_by_patience(recs)
    for r in recs:
        assert r["loss_div"] <= TG_LOSS_DIV, (r["frame"], r["loss_div"])
    log = _read(EV, "taylor_green", "chain.log")
    assert re.search(r"restore: output_tg <- \d+ checkpoints", log)
    assert re.search(r"--- tg_advance resuming from frame \d+", log)


def test_taylor_green_frames_meet_the_closed_form_and_the_jax_fit():
    """The committed frames through the port's and the JAX package's
    analyzers (the same table), against the closed form and against the
    JAX package's own fit and first frame, made on the CPU
    (``taylor_green_jax_cpu``)."""
    run = os.path.join(EV, "taylor_green")
    got = _port_output("analyze_taylor_green2d", [run, "1"])
    assert_same_numbers(got, _jax_output("analyze_taylor_green2d.py",
                                         [run, "1"]))
    speed, rows = _tg(got)
    _, jax = _tg(_read(EV, "taylor_green_jax_cpu",
                       "analyze_taylor_green2d.txt"))
    assert sorted(rows)[:2] == [0, 1] and len(rows) >= 3
    for n, t in rows.items():
        # the frame-100 bound holds at every frame before it
        assert float(t[2]) * speed <= TG_L1, (n, t)
        assert float(t[3]) <= TG_GRID_DIV * float(jax[min(n, 1)][3]), (n, t)


def test_taylor_green_card_table_meets_the_gates():
    speed, rows = _tg(_read(EV, "taylor_green",
                            "analyze_taylor_green2d.txt"))
    _, jax = _tg(_read(EV, "taylor_green_jax_cpu",
                       "analyze_taylor_green2d.txt"))
    assert 0 in rows and len(rows) >= 3
    for n, t in rows.items():
        assert float(t[2]) * speed <= TG_L1, (n, t)
        assert float(t[3]) <= TG_GRID_DIV * float(jax[min(n, 1)][3]), (n, t)
