"""The production chain on the port's entry points: the JAX package's
``scripts/run_production_chain5.sh`` (with ``scripts/restore_runs.sh``'s
role) in Python.

Each step runs one entry point in a child process
(``python -m gaussian_fluids_torch.initialize3d ...``), its output
appended to ``{logdir}/{name}.log``, so a child that crashes (a lost CUDA
context, a signal) ends its step and not the chain. The helpers keep the
bash chain's semantics:

* ``run``: skip a step whose ``{name}.done`` exists; otherwise log
  ``=== name: ...`` to ``chain.log``, run, and touch ``.done`` on
  success; on failure log ``=== name FAILED rc=N`` (128+N: killed by
  signal N) and the last <= 5 lines this attempt appended, each as
  ``    [name tail] ...`` (an attempt that appended nothing died at
  startup, and the line says so);
* ``need``: a step runs only once its prerequisite's marker exists;
* ``advance``: resume from the run's last ``gaussian_velocity_{k}.pt``
  with ``--start_frame k`` and the remaining horizon ``T - k*dt`` (the
  frame loop counts its time from 0, reference 2D/advance.py:354);
* ``density``: resume the replay from the last frame that every
  density's ``density_{tag}_{n}.vti`` has (min over tags of max n);
* ``advance_chunk``: at most ``chunk`` more frames of a ``total``-frame
  horizon, done at the horizon; three attempts in a row without progress
  park the step (``.lastk``, ``.strikes``; remove ``.strikes`` to retry);
* ``seed_from`` copies another run's frame 0 into a run directory that
  has none; ``restore`` copies back the checkpoints a saved directory
  holds and a run directory lacks, so a run resumes on a fresh machine.

Unlike the bash chain, a resumed or chunked advance passes
``--last_time (n - 1/2) * dt`` for the n frames it is to run, n counted
by the entry points' own frame loop (``while t < last_time: t += dt``
from 0, ``loop_frames``), so that it ends where an uncut run ends: the
frame loop's float sum can fall an ulp short of ``T - k*dt`` or of
``n * dt`` and run one frame more (Taylor-Green resumed at k >= 176 would
write frame 201). And ``main`` exits nonzero when a step failed, was
parked or could not run for a missing prerequisite: it goes on past such
a step, as the bash chain does, but a chain that failed does not end
with rc 0.

    python -m gaussian_fluids_torch.scripts.production [--root DIR]
        [--logdir DIR] [--steps a,b,...] [--chunk NAME=N]
        [--horizon NAME=N] [--seed NAME=CKPT] [--restore DIR]
        [--args 'FLAGS']

The entry points run on their default device, the first GPU; ``--args``
appends flags to every entry point (``--args='--device cpu'`` for a run
on the CPU, ``--args=--no_viz``).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shlex
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

from gaussian_fluids_torch.scripts import _runs

_PKG = "gaussian_fluids_torch"
_SRC = Path(__file__).resolve().parents[2]
_DENSITY = re.compile(r"density_([a-z])_(\d+)\.vti$")


def _clock() -> str:
    return time.strftime("%H:%M:%S", time.gmtime())


def loop_frames(dt: float, last_time: float) -> int:
    """Frames the entry points' frame loop runs from t = 0 over
    ``last_time`` (``while t < last_time: t += dt``, in floats)."""
    t, n = 0.0, 0
    while t < last_time:
        t += dt
        n += 1
    return n


def _last_time(n: int, dt: float) -> float:
    """A ``--last_time`` under which the frame loop runs exactly n frames."""
    return max(0.0, (n - 0.5) * dt)


def last_frame(run_dir) -> int:
    """The largest k of the run's ``gaussian_velocity_{k}.pt``, 0 if none."""
    return max(_runs.frames(str(run_dir)), default=0)


def last_density_frame(run_dir) -> int:
    """The last frame every density has: min over tags of each tag's
    largest n in ``density_{tag}_{n}.vti`` (a crash mid-frame leaves one
    tag a frame ahead; replaying from the min recomputes the torn frame)."""
    per = collections.defaultdict(set)
    for f in Path(run_dir).glob("density_*_*.vti"):
        m = _DENSITY.search(f.name)
        if m:
            per[m.group(1)].add(int(m.group(2)))
    return min((max(v) for v in per.values()), default=0)


def seed_from(run_dir, checkpoint) -> bool:
    """Copy ``checkpoint`` in as the run's ``gaussian_velocity_0.pt`` when
    the run has none; True if it copied."""
    dst = Path(run_dir) / "gaussian_velocity_0.pt"
    if dst.exists():
        return False
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy2(checkpoint, dst)
    return True


def restore(run_dir, saved_dir) -> int:
    """Copy the ``gaussian_velocity_*.pt`` that ``saved_dir`` holds and
    ``run_dir`` lacks (mtimes kept); returns how many."""
    run_dir = Path(run_dir)
    n = 0
    for k, src in _runs.frames(str(saved_dir)).items():
        dst = run_dir / Path(src).name
        if not dst.exists():
            run_dir.mkdir(parents=True, exist_ok=True)
            shutil.copy2(src, dst)
            n += 1
    return n


def entry(module: str, *flags) -> list:
    """argv of one entry point of the port, in a child interpreter."""
    return [sys.executable, "-m", f"{_PKG}.{module}", *map(str, flags)]


class Chain:
    """The chain's helpers over one log directory. ``failed`` collects the
    steps that failed, were parked or could not run, in order."""

    def __init__(self, logdir, env=None):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.failed: list = []
        self.parked: set = set()
        self.env = dict(os.environ if env is None else env)
        path = self.env.get("PYTHONPATH")
        self.env["PYTHONPATH"] = (f"{_SRC}{os.pathsep}{path}" if path
                                  else str(_SRC))

    def _file(self, name: str) -> Path:
        return self.logdir / name

    def log(self, line: str, echo: bool = True):
        if echo:
            print(line, flush=True)
        with open(self._file("chain.log"), "a") as f:
            f.write(line + "\n")

    def fail(self, name: str):
        if name not in self.failed:
            self.failed.append(name)

    def need(self, marker: str, name: str) -> bool:
        """Whether ``name``'s prerequisite ``marker`` exists; logs the skip
        (a step that cannot run counts as failed)."""
        if self._file(marker).exists():
            return True
        self.log(f"--- skipping {name} (missing prerequisite {marker})")
        self.fail(name)
        return False

    def _attempt(self, name: str, argv, ok_line: str) -> bool:
        # the child interpreter is logged as `python`, as the bash chain's
        shown = ["python" if a == sys.executable else str(a) for a in argv]
        self.log(f"=== {name}: {shlex.join(shown)} ({_clock()})")
        out = self._file(f"{name}.log")
        pre = out.stat().st_size if out.exists() else 0
        with open(out, "ab") as f:
            rc = subprocess.run(list(map(str, argv)), stdout=f,
                                stderr=subprocess.STDOUT, env=self.env,
                                stdin=subprocess.DEVNULL).returncode
        if rc == 0:
            self.log(f"=== {name} {ok_line} ({_clock()})")
            return True
        rc = 128 - rc if rc < 0 else rc
        self.log(f"=== {name} FAILED rc={rc} ({_clock()})")
        with open(out, "rb") as f:
            f.seek(pre)
            lines = f.read().decode(errors="replace").splitlines()
        tail = ([f"    [{name} tail] {s}" for s in lines[-5:]] if lines
                else [f"    [{name} tail] (attempt appended no output — "
                      "died at startup)"])
        for s in tail:
            self.log(s, echo=False)
        self.fail(name)
        return False

    def run(self, name: str, argv) -> Optional[bool]:
        """One step; None if already done, else whether it succeeded."""
        if self._file(f"{name}.done").exists():
            print(f"skip {name} (done)")
            return None
        ok = self._attempt(name, argv, "DONE")
        if ok:
            self._file(f"{name}.done").touch()
        return ok

    def advance(self, name: str, run_dir, dt: float, last_time: float,
                argv):
        """``run`` an advance entry point over the horizon ``last_time``,
        resumed from the run's last checkpoint."""
        if self._file(f"{name}.done").exists():
            print(f"skip {name} (done)")
            return None
        k = last_frame(run_dir)
        if k:
            n = max(0, loop_frames(dt, last_time) - k)
            self.log(f"--- {name} resuming from frame {k} (remaining "
                     f"t={max(0.0, last_time - k * dt)}, to frame {k + n})")
            return self.run(name, [*argv, "--start_frame", k,
                                   "--last_time", _last_time(n, dt)])
        return self.run(name, [*argv, "--last_time", last_time])

    def density(self, name: str, run_dir, argv):
        """``run`` the density replay, resumed from the last frame every
        density has."""
        if self._file(f"{name}.done").exists():
            print(f"skip {name} (done)")
            return None
        k = last_density_frame(run_dir)
        if k:
            self.log(f"--- {name} resuming from density frame {k}")
            return self.run(name, [*argv, "--start_frame", k])
        return self.run(name, argv)

    def advance_chunk(self, name: str, run_dir, dt: float, total: int,
                      chunk: int, argv) -> bool:
        """At most ``chunk`` more frames of a ``total``-frame horizon;
        True once the horizon is reached (the step is then done). A
        third attempt in a row that finds no progress parks the step."""
        done = self._file(f"{name}.done")
        if done.exists():
            return True
        k = last_frame(run_dir)
        if k >= total:
            done.touch()
            self.log(f"=== {name} DONE (horizon {total} reached) "
                     f"({_clock()})")
            return True
        lastk_f, strikes_f = (self._file(f"{name}.lastk"),
                              self._file(f"{name}.strikes"))
        lastk = int(lastk_f.read_text()) if lastk_f.exists() else -1
        strikes = 0
        if k == lastk:
            strikes = 1 + (int(strikes_f.read_text())
                           if strikes_f.exists() else 0)
        lastk_f.write_text(f"{k}\n")
        strikes_f.write_text(f"{strikes}\n")
        if strikes >= 3:
            self.log(f"=== {name} PARKED after 3 no-progress chunks at "
                     f"frame {k} (rm {strikes_f} to retry) ({_clock()})")
            self.parked.add(name)
            self.fail(name)
            return False
        n = min(chunk, total - k)
        self.log(f"--- {name} chunk: frames {k} -> {k + n} of {total}")
        flags = ((["--start_frame", k] if k else [])
                 + ["--last_time", _last_time(n, dt)])
        self._attempt(name, [*argv, *flags], "chunk DONE")
        return False


class Step(NamedTuple):
    name: str
    kind: str           # init | advance | density | chunk
    run_dir: str        # relative to the chain's root
    argv: tuple         # module and flags, without --dir
    need: Optional[str] = None
    dt: float = 0.0
    last_time: float = 0.0
    total: int = 0      # chunk steps: the horizon in frames
    chunk: int = 0      # chunk steps: frames a first-pass chunk advances
    seed: Optional[str] = None  # another run's frame 0 that seeds this one

    @property
    def frames(self) -> int:
        return self.total or loop_frames(self.dt, self.last_time)


VPS = ("vortices_pass", "vortices_pass_narrow", "vortices_pass_noslip",
       "vortices_pass_particles")


def _vp(scene):
    return ("vp", "output_vp") if scene == "vortices_pass" else (
        scene, f"output_{scene}")


def chain5() -> list:
    """run_production_chain5.sh's steps, in its order (reference
    README.md:53-85 run commands, 3D horizons from the Justfile), then
    the reference's Taylor-Green run (README.md:64), which chain5 does
    not run."""
    s = []

    def pair(tag, dim, scene, out, dt, last, extra=()):
        s.append(Step(f"{tag}_init", "init", out,
                      (f"initialize{dim}d", "--init_cond", scene)))
        s.append(Step(f"{tag}_advance", "advance", out,
                      (f"advance{dim}d", "--init_cond", scene, "--dt", dt,
                       *extra), need=f"{tag}_init.done", dt=dt,
                      last_time=last))

    pair("rc", 3, "ring_collide", "output_3d_ring_collide", .1, 2.0)
    s.append(Step("rc_density", "density", "output_3d_ring_collide",
                  ("advance_density3d", "--init_cond", "ring_collide",
                   "--dt", .1), need="rc_advance.done"))
    pair("rwo", 3, "ring_with_obstacle", "output_3d_rwo", .1, 2.0)
    pair("svr", 3, "single_vortex_ring", "output_3d_svr", .1, 2.0)
    pair("tv", 2, "taylor_vortex", "output_tv", .01, 4.0)
    for scene in VPS:
        tag, out = _vp(scene)
        s.append(Step(f"{tag}_init", "init", out,
                      ("initialize2d", "--init_cond", scene)))
    for scene in VPS:
        tag, out = _vp(scene)
        s.append(Step(f"{tag}_advance", "chunk", out,
                      ("advance2d", "--init_cond", scene, "--dt", .01),
                      need=f"{tag}_init.done", dt=.01, total=500, chunk=50))
    # the cached-target A/B, seeded from the exact run's frame 0
    s.append(Step("rc_tg128_advance", "advance", "output_3d_rc_tg128",
                  ("advance3d", "--init_cond", "ring_collide", "--dt", .1,
                   "--target_grid", 128, "--no_viz"), dt=.1, last_time=2.0,
                  seed="output_3d_ring_collide/gaussian_velocity_0.pt"))
    pair("tg", 2, "taylor_green", "output_tg", .001, 0.2)
    return s


ROUND_ROBIN_CHUNK = 100   # frames a chunk advances after the first pass


def _pairs(values, name):
    out = {}
    for v in values:
        key, sep, val = v.partition("=")
        if not sep:
            raise SystemExit(f"{name} expects NAME=VALUE, got {v!r}")
        out[key] = val
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=".",
                   help="directory that holds the runs' output_* "
                        "directories (default: the current one)")
    p.add_argument("--logdir", default="runs_port",
                   help="chain.log, each step's log and its markers")
    p.add_argument("--steps", default=None,
                   help="comma-separated step names (default: all)")
    p.add_argument("--chunk", action="append", default=[],
                   metavar="NAME=N",
                   help="advance step NAME at most N frames in this call")
    p.add_argument("--horizon", action="append", default=[],
                   metavar="NAME=N",
                   help="cut advance step NAME's horizon to N frames")
    p.add_argument("--seed", action="append", default=[],
                   metavar="NAME=CKPT",
                   help="init step NAME takes CKPT as its frame 0 "
                        "instead of running")
    p.add_argument("--restore", default=None, metavar="DIR",
                   help="first copy back the checkpoints DIR/<run dir>/ "
                        "holds and the run directory lacks")
    p.add_argument("--args", default="",
                   help="flags appended to every entry point "
                        "(e.g. '--device cpu --max_epoch 60')")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    steps = chain5()
    names = [s.name for s in steps]
    if args.steps:
        chosen = args.steps.split(",")
        unknown = sorted(set(chosen) - set(names))
        if unknown:
            raise SystemExit(f"unknown steps {unknown}; the chain's: "
                             f"{', '.join(names)}")
        steps = [s for s in steps if s.name in chosen]
    chunks = {k: int(v) for k, v in _pairs(args.chunk, "--chunk").items()}
    horizons = {k: int(v)
                for k, v in _pairs(args.horizon, "--horizon").items()}
    seeds = _pairs(args.seed, "--seed")
    unknown = sorted({*chunks, *horizons, *seeds} - set(names))
    if unknown:
        raise SystemExit(f"--chunk, --horizon or --seed names no step of "
                         f"the chain: {unknown}")
    root = Path(args.root).resolve()
    extra = shlex.split(args.args)
    chain = Chain(args.logdir)

    def run_dir(s):
        return root / s.run_dir

    def argv_of(s):
        return entry(*s.argv, "--dir", run_dir(s), *extra)

    if args.restore:
        for d in sorted({s.run_dir for s in steps}):
            n = restore(root / d, Path(args.restore) / d)
            if n:
                chain.log(f"restore: {d} <- {n} checkpoints from "
                          f"{args.restore}")
        # an init step whose frame 0 came back is done, as the bash
        # restore trusted *_init markers with a restorable frame 0
        for s in steps:
            done = chain.logdir / f"{s.name}.done"
            if (s.kind == "init" and not done.exists()
                    and (run_dir(s) / "gaussian_velocity_0.pt").exists()):
                done.touch()
                chain.log(f"restore: marker {s.name}.done")

    def advance_step(s, chunk=None):
        """One call's worth of an advance or chunk step; True when the
        step needs no further chunk in this call."""
        if s.need and not chain.need(s.need, s.name):
            return True
        total = horizons.get(s.name, s.frames)
        if s.kind == "advance" and s.name not in chunks \
                and s.name not in horizons:
            chain.advance(s.name, run_dir(s), s.dt, s.last_time, argv_of(s))
            return True
        n = chunks.get(s.name, chunk or s.chunk or total)
        reached = chain.advance_chunk(s.name, run_dir(s), s.dt, total, n,
                                      argv_of(s))
        return reached or s.name in chain.parked or s.name in chunks

    for s in steps:
        if s.kind == "init":
            if s.name in seeds:
                if seed_from(run_dir(s), seeds[s.name]):
                    chain.log(f"--- {s.name}: frame 0 seeded from "
                              f"{seeds[s.name]}")
                (chain.logdir / f"{s.name}.done").touch()
                continue
            chain.run(s.name, argv_of(s))
        elif s.kind == "density":
            if not s.need or chain.need(s.need, s.name):
                chain.density(s.name, run_dir(s), argv_of(s))
        elif s.seed and not (chain.logdir / f"{s.name}.done").exists():
            # seeded from another run's frame 0, as chain5 :246-251
            src = root / s.seed
            if src.exists():
                seed_from(run_dir(s), src)
                advance_step(s)
            else:
                chain.log(f"--- skipping {s.name} (missing {src})")
                chain.fail(s.name)
        else:
            advance_step(s)
    # the round robin: chunk steps in turns until each is done or parked
    rr = [s for s in steps if s.kind == "chunk" and s.name not in chunks]
    while rr:
        rr = [s for s in rr if not advance_step(s, ROUND_ROBIN_CHUNK)]
    chain.log(f"=== chain complete ({_clock()})"
              + (f": failed {', '.join(chain.failed)}" if chain.failed
                 else ""))
    return 1 if chain.failed else 0


if __name__ == "__main__":
    sys.exit(main())
