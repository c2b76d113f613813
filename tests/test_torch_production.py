"""The production chain and the run report on the port
(``gaussian_fluids_torch/scripts/production.py``, ``report_runs.py``).

The chain's helpers run stand-in commands, as tests/test_chain_logging.py
runs the bash chain's: done steps skip, a failure leaves its rc and only
its own attempt's tail in chain.log, the dependency gate skips, resumes
take ``--start_frame k`` with the remaining horizon, chunks stop at their
horizon or park after three attempts without progress, and ``main`` ends
nonzero after a failure. One chain runs the port's entry points on the
CPU (Taylor-Green, 60 epochs): cut after frame 1, restored into a fresh
directory and resumed to frame 2. ``report_runs`` prints the JAX
script's lines on the same directories.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from gaussian_fluids_torch.scripts import production, report_runs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = os.path.join(REPO, "runs_r2_evidence", "ckpts")
PY = sys.executable

# a stand-in advance entry point: writes the frames the port's frame loop
# would (``while t < last_time: t += dt``) as empty checkpoints, and its
# argv to argv.txt; exits 1 under --fail
STAND_IN = textwrap.dedent("""\
    import os, sys
    a = sys.argv[1:]
    def flag(name, default):
        return type(default)(a[a.index(name) + 1]) if name in a else default
    d = flag("--dir", "")
    open(os.path.join(d, "argv.txt"), "a").write(" ".join(a) + "\\n")
    print("stand-in", " ".join(a))
    if "--fail" in a:
        sys.exit(1)
    t, k, dt, last = 0.0, flag("--start_frame", 0), flag("--dt", .1), \\
        flag("--last_time", 1.0)
    while t < last:
        k += 1
        open(os.path.join(d, f"gaussian_velocity_{k}.pt"), "w").close()
        t += dt
""")


@pytest.fixture
def chain(tmp_path):
    return production.Chain(tmp_path / "log")


def _log(chain):
    return (chain.logdir / "chain.log").read_text()


def _stand_in(tmp_path, run_dir, *flags):
    script = tmp_path / "stand_in.py"
    script.write_text(STAND_IN)
    os.makedirs(run_dir, exist_ok=True)
    return [PY, str(script), "--dir", str(run_dir), *flags]


def _frames(run_dir):
    return sorted(production._runs.frames(str(run_dir)))


def test_done_step_is_skipped(chain):
    (chain.logdir / "x.done").touch()
    assert chain.run("x", [PY, "-c", "raise SystemExit(1)"]) is None
    assert not (chain.logdir / "chain.log").exists()
    assert chain.failed == []


def test_success_touches_done(chain):
    assert chain.run("ok", [PY, "-c", "print('hello')"]) is True
    assert (chain.logdir / "ok.done").exists()
    assert "hello" in (chain.logdir / "ok.log").read_text()
    assert "=== ok DONE" in _log(chain)


def test_failed_attempt_records_rc_and_only_its_own_tail(chain):
    code = "import sys; print('{}'); print('oops', file=sys.stderr); " \
           "sys.exit(3)"
    assert chain.run("boom", [PY, "-c", code.format("first")]) is False
    assert chain.run("boom", [PY, "-c", code.format("second")]) is False
    log = _log(chain)
    assert log.count("=== boom FAILED rc=3") == 2
    tails = [ln for ln in log.splitlines() if "[boom tail]" in ln]
    # stdout and stderr of each attempt, and the second attempt's tail
    # holds only its own lines
    assert tails == ["    [boom tail] first", "    [boom tail] oops",
                     "    [boom tail] second", "    [boom tail] oops"]
    assert not (chain.logdir / "boom.done").exists()
    assert chain.failed == ["boom"]


def test_tail_keeps_the_last_five_lines(chain):
    code = "for i in range(9): print('line', i)\nraise SystemExit(2)"
    chain.run("long", [PY, "-c", code])
    tails = [ln for ln in _log(chain).splitlines() if "[long tail]" in ln]
    assert tails == [f"    [long tail] line {i}" for i in range(4, 9)]


def test_silent_failure_says_it_died_at_startup(chain):
    chain.run("silent", [PY, "-c", "raise SystemExit(7)"])
    log = _log(chain)
    assert "=== silent FAILED rc=7" in log
    assert "[silent tail] (attempt appended no output — died at startup)" \
        in log


def test_killed_child_records_128_plus_signal(chain):
    chain.run("killed", [PY, "-c",
                         "import os, signal; os.kill(os.getpid(), 9)"])
    assert "=== killed FAILED rc=137" in _log(chain)


def test_dependency_gate_skips(chain):
    assert chain.need("missing.done", "later") is False
    assert "--- skipping later (missing prerequisite missing.done)" \
        in _log(chain)
    (chain.logdir / "there.done").touch()
    assert chain.need("there.done", "later2") is True
    assert chain.failed == ["later"]


def test_advance_resumes_with_the_remaining_horizon(chain, tmp_path):
    run = tmp_path / "run"
    argv = _stand_in(tmp_path, run, "--dt", "0.1")
    for k in range(4):
        (run / f"gaussian_velocity_{k}.pt").touch()
    assert chain.advance("adv", run, .1, 2.0, argv) is True
    args = (run / "argv.txt").read_text().split()
    i = args.index("--start_frame")
    assert args[i + 1] == "3"
    # the 17 frames left of the 20 an uncut run makes, as (17 - 1/2) * dt
    assert float(args[args.index("--last_time") + 1]) == 16.5 * .1
    assert "--- adv resuming from frame 3 (remaining t=1.7, to frame 20)" \
        in _log(chain)
    assert _frames(run)[-1] == 20


@pytest.mark.parametrize("dt,last_time,frames", [(.1, 2.0, 20),
                                                 (.001, .2, 200),
                                                 (.01, 4.0, 401)])
def test_resumed_run_ends_where_an_uncut_run_ends(dt, last_time, frames):
    """At every k the resumed frame loop runs to the uncut run's last
    frame; T - k*dt, the bash chain's horizon, overshoots by one frame at
    some k (Taylor-Green at k >= 176, Ring-Collide at 9 and 10)."""
    assert production.loop_frames(dt, last_time) == frames
    overshoot = []
    for k in range(1, frames):
        n = frames - k
        assert production.loop_frames(dt, production._last_time(n, dt)) == n
        if k + production.loop_frames(dt, last_time - k * dt) != frames:
            overshoot.append(k)
    assert overshoot


def test_advance_from_scratch_takes_the_whole_horizon(chain, tmp_path):
    run = tmp_path / "run"
    argv = _stand_in(tmp_path, run, "--dt", "0.1")
    chain.advance("adv", run, .1, 2.0, argv)
    args = (run / "argv.txt").read_text().split()
    assert "--start_frame" not in args
    assert args[args.index("--last_time") + 1] == "2.0"
    assert _frames(run) == list(range(1, 21))


def test_density_resumes_from_the_min_of_maxes(chain, tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    for n in range(6):
        (run / f"density_a_{n}.vti").touch()
    for n in range(5):
        (run / f"density_b_{n}.vti").touch()
    (run / "density_small_a_9.npz").touch()
    assert production.last_density_frame(run) == 4
    chain.density("dns", run, [PY, "-c", "import sys; print(sys.argv)"])
    assert "--- dns resuming from density frame 4" in _log(chain)
    assert "'--start_frame', '4'" in (chain.logdir / "dns.log").read_text()
    assert production.last_density_frame(tmp_path) == 0


def test_advance_chunk_reaches_its_horizon_exactly(chain, tmp_path):
    run = tmp_path / "run"
    argv = _stand_in(tmp_path, run, "--dt", "0.1")
    (run / "gaussian_velocity_0.pt").touch()
    reached, ends = [], []
    for _ in range(4):
        reached.append(chain.advance_chunk("ch", run, .1, 20, 8, argv))
        ends.append(_frames(run)[-1])
    # exactly 8 frames a chunk (8 * 0.1 in floats would run 9), then the
    # last 4, then the horizon marks the step done
    assert ends == [8, 16, 20, 20]
    assert reached == [False, False, False, True]
    assert (chain.logdir / "ch.done").exists()
    lines = (run / "argv.txt").read_text().splitlines()
    assert "--start_frame" not in lines[0]
    assert "--start_frame 8" in lines[1] and "--start_frame 16" in lines[2]
    assert "=== ch DONE (horizon 20 reached)" in _log(chain)
    assert chain.failed == []


def test_advance_chunk_parks_after_three_attempts_without_progress(
        chain, tmp_path):
    run = tmp_path / "run"
    argv = _stand_in(tmp_path, run, "--dt", "0.1", "--fail")
    (run / "gaussian_velocity_0.pt").touch()
    (run / "gaussian_velocity_5.pt").touch()
    for _ in range(4):
        assert chain.advance_chunk("stuck", run, .1, 20, 8, argv) is False
    log = _log(chain)
    assert log.count("=== stuck: ") == 3
    assert "=== stuck PARKED after 3 no-progress chunks at frame 5" in log
    assert (chain.logdir / "stuck.strikes").read_text().strip() == "3"
    assert chain.parked == {"stuck"} and chain.failed == ["stuck"]
    # progress resets the count
    (run / "gaussian_velocity_6.pt").touch()
    chain.advance_chunk("stuck", run, .1, 20, 8, argv)
    assert (chain.logdir / "stuck.strikes").read_text().strip() == "0"


def test_seed_and_restore(tmp_path):
    src = tmp_path / "saved"
    src.mkdir()
    for k in (0, 1, 2):
        (src / f"gaussian_velocity_{k}.pt").write_text(str(k))
    os.utime(src / "gaussian_velocity_2.pt", (1.0e9, 1.0e9))
    run = tmp_path / "run"
    assert production.seed_from(run, src / "gaussian_velocity_1.pt")
    assert (run / "gaussian_velocity_0.pt").read_text() == "1"
    assert not production.seed_from(run, src / "gaussian_velocity_2.pt")
    # restore keeps what the run has, brings back the rest, mtimes kept
    assert production.restore(run, src) == 2
    assert (run / "gaussian_velocity_0.pt").read_text() == "1"
    assert os.path.getmtime(run / "gaussian_velocity_2.pt") == 1.0e9
    assert production.restore(run, src) == 0
    assert production.restore(run, tmp_path / "nothing") == 0


def test_chain_lists_chain5_in_its_order():
    names = [s.name for s in production.chain5()]
    assert names[:5] == ["rc_init", "rc_advance", "rc_density", "rwo_init",
                         "rwo_advance"]
    assert names.index("tv_advance") < names.index("vp_init") \
        < names.index("vp_advance") < names.index("rc_tg128_advance") \
        < names.index("tg_init")
    steps = {s.name: s for s in production.chain5()}
    assert steps["rc_advance"].frames == 20
    # the entry points' own frame loop: from 0 over t = 4, 401 frames
    assert steps["tv_advance"].frames == 401
    assert steps["tg_advance"].frames == 200
    assert steps["vp_advance"].total == 500 and steps["vp_advance"].chunk \
        == 50
    for s in steps.values():
        assert "--device" not in s.argv


def _main(tmp_path, *argv):
    return production.main(["--root", str(tmp_path / "root"), "--logdir",
                            str(tmp_path / "log"), *argv])


def test_main_exits_nonzero_after_a_failed_step(tmp_path, capsys):
    # the init step fails (an unknown flag), its advance step is gated
    rc = _main(tmp_path, "--steps", "tg_init,tg_advance",
               "--args=--device cpu --no_such_flag")
    assert rc == 1
    log = (tmp_path / "log" / "chain.log").read_text()
    assert "=== tg_init FAILED rc=2" in log
    assert "--- skipping tg_advance (missing prerequisite tg_init.done)" \
        in log
    assert "failed tg_init, tg_advance" in log


@pytest.mark.parametrize("flags", [["--steps", "no_such_step"],
                                   ["--chunk", "no_such_step=3"],
                                   ["--horizon", "tv_advance"],
                                   ["--seed", "no_such_init=x.pt"]])
def test_main_rejects_unknown_steps(tmp_path, flags):
    with pytest.raises(SystemExit):
        _main(tmp_path, *flags)


def test_chain_end_to_end_cut_restored_and_resumed(tmp_path):
    """Taylor-Green through the port's entry points on the CPU: init and
    frame 1, then a fresh root restored from the first and frame 2."""
    flags = "--args=--device cpu --max_epoch 60 --no_viz"
    env = dict(os.environ, PYTHONPATH=REPO)
    first = subprocess.run(
        [PY, "-m", "gaussian_fluids_torch.scripts.production", "--root",
         str(tmp_path / "a"), "--logdir", str(tmp_path / "a_log"),
         "--steps", "tg_init,tg_advance", "--chunk", "tg_advance=1", flags],
        env=env, capture_output=True, text=True, timeout=600)
    assert first.returncode == 0, first.stdout + first.stderr
    run_a = tmp_path / "a" / "output_tg"
    assert _frames(run_a) == [0, 1]
    # the saved run comes back in a fresh root; its init is done there
    shutil.copytree(run_a, tmp_path / "saved" / "output_tg")
    rc = production.main(["--root", str(tmp_path / "b"), "--logdir",
                          str(tmp_path / "b_log"), "--restore",
                          str(tmp_path / "saved"), "--steps",
                          "tg_init,tg_advance", "--chunk", "tg_advance=1",
                          flags])
    assert rc == 0
    run_b = tmp_path / "b" / "output_tg"
    assert _frames(run_b) == [0, 1, 2]
    log = (tmp_path / "b_log" / "chain.log").read_text()
    assert "restore: output_tg <- 2 checkpoints" in log
    assert "restore: marker tg_init.done" in log
    assert "--- tg_advance chunk: frames 1 -> 2 of 200" in log
    assert "=== tg_init:" not in log
    adv = (tmp_path / "b_log" / "tg_advance.log").read_text()
    assert "[frame 2]" in adv and "[frame 1]" not in adv
    from gaussian_fluids_torch.io.checkpoint import load_checkpoint
    from gaussian_fluids_torch.scripts import analyze_taylor_green2d
    mix, _ = load_checkpoint(str(run_b / "gaussian_velocity_2.pt"),
                             device="cpu")
    assert mix.n_alive() >= 576
    assert analyze_taylor_green2d.main([str(run_b), "1", "--device",
                                        "cpu"]) == 0


# report_runs: the JAX script's lines on the same directories

def _jax_report(dirs):
    out = subprocess.run([PY, os.path.join(REPO, "scripts",
                                           "report_runs.py"), *dirs],
                         capture_output=True, text=True, check=True,
                         cwd=REPO, timeout=300)
    return out.stdout


def _port_report(dirs, capsys):
    capsys.readouterr()
    report_runs.main(list(dirs))
    return capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(os.listdir(CKPTS)))
def test_report_runs_prints_the_jax_line(name, capsys):
    d = os.path.join("runs_r2_evidence", "ckpts", name)
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        got = _port_report([d], capsys)
    finally:
        os.chdir(cwd)
    assert got == _jax_report([d])
    assert got.startswith(f"{d}: frames 0..")


def test_report_runs_wall_statistics_match(tmp_path, capsys):
    """Frames with mtimes set: restored copies (< 1 s apart), a restart
    gap (> 5x the median) and a gap in the frame numbers."""
    run = tmp_path / "output_tv_part"
    run.mkdir()
    stamps = {0: 0.0, 10: 0.5, 20: 60.0, 21: 125.0, 22: 185.0, 23: 2000.0,
              24: 2071.0, 25: 2130.0}
    for n, t in stamps.items():
        src = os.path.join(CKPTS, "output_tv",
                           f"gaussian_velocity_{(0, 10, 20)[n % 3]}.pt")
        dst = run / f"gaussian_velocity_{n}.pt"
        shutil.copy(src, dst)
        os.utime(dst, (1.0e9 + t, 1.0e9 + t))
    got = _port_report([str(run)], capsys)
    assert got == _jax_report([str(run)])
    assert "per-frame wall median 60.0 s" in got and "(n=5)" in got
    assert report_runs.main([str(tmp_path / "empty")]) is None


def test_frame_summary_reads_the_frame_lines(capsys):
    """``--frames`` on the JAX run's committed log tail: its last four
    ``[frame k]`` lines and the epochs of the phases before each."""
    log = os.path.join(REPO, "runs_r2_evidence", "tv_advance.log.tail")
    recs = report_runs.frame_records(log)
    assert [r["frame"] for r in recs] == [397, 398, 399, 400]
    last = recs[-1]
    assert (last["solve"], last["clone"], last["advect"], last["project"],
            last["viz"], last["save"], last["n"], last["capacity"]) == (
        69.5, 38.8, 0.8, 29.9, 1.4, 0.3, 65941, 75776)
    assert last["seconds"] == pytest.approx(71.2)
    assert last["clone_epochs"] == (6300, True)
    assert last["project_epochs"] == (5600, True)
    # the tail starts inside frame 397's clone: no clone total before it
    assert recs[0]["clone_epochs"] is None
    report_runs.main(["--frames", log])
    line = capsys.readouterr().out
    assert "frames 397..400 (4)" in line
    assert "clone epochs 4200-8000 (median 6300, 3 of 3 stopped by " \
        "patience)" in line
    assert "N 65457 -> 65941 (capacity 75776 -> 75776)" in line


def test_frame_summary_marks_a_phase_at_its_budget(tmp_path):
    log = tmp_path / "a.log"
    log.write_text("[clone] Total epoch: 300 (Reached maximum iteration "
                   "number)\n[projection] Total epoch: 200\n[frame 3] solve "
                   "2.5s (clone 1.0 advect 0.5 project 1.0) viz 0.0s save "
                   "0.1s (N=10/512)\n")
    (rec,) = report_runs.frame_records(log)
    assert rec["clone_epochs"] == (300, False)
    assert rec["project_epochs"] == (200, True)
    assert "0 of 1 stopped by patience" in report_runs.frame_summary(log)
    assert report_runs.frame_summary(tmp_path / "a.log") is not None
    empty = tmp_path / "b.log"
    empty.write_text("nothing\n")
    assert report_runs.frame_summary(empty) is None


@pytest.fixture
def children(monkeypatch):
    """The argv of each child the chain starts, none of them run (each
    ends with rc 0)."""
    seen = []

    class Done:
        returncode = 0

    def fake_run(argv, **kw):
        seen.append(argv)
        return Done()

    monkeypatch.setattr(production.subprocess, "run", fake_run)
    return seen


def test_main_runs_the_entry_points_on_their_default_device(tmp_path,
                                                            children):
    """Without --args the children get no --device flag: the entry points
    take their default, the first GPU."""
    seen = children
    assert _main(tmp_path, "--steps", "rc_init,tv_init") == 0
    assert [a[1:3] for a in seen] == [
        ["-m", "gaussian_fluids_torch.initialize3d"],
        ["-m", "gaussian_fluids_torch.initialize2d"]]
    assert all("--device" not in a for a in seen)
    assert seen[0][-2:] == ["--dir", str(tmp_path / "root" /
                                         "output_3d_ring_collide")]


def test_tg128_run_is_seeded_from_the_exact_runs_frame_0(tmp_path,
                                                         children):
    seen = children
    # without the exact run's frame 0 the step cannot run
    assert _main(tmp_path, "--steps", "rc_tg128_advance") == 1
    assert seen == []
    exact = tmp_path / "root" / "output_3d_ring_collide"
    exact.mkdir(parents=True)
    (exact / "gaussian_velocity_0.pt").write_text("frame 0")
    assert _main(tmp_path, "--steps", "rc_tg128_advance") == 0
    seeded = tmp_path / "root" / "output_3d_rc_tg128"
    assert (seeded / "gaussian_velocity_0.pt").read_text() == "frame 0"
    (argv,) = seen
    assert argv[argv.index("--target_grid") + 1] == "128"
    assert argv[-2:] == ["--last_time", "2.0"]
