"""Parity of the port's density replay with the JAX package's, on the CPU:
the banded value evaluation (the port's plain twin of its CUDA kernel, at
the kernel's tiles, against the JAX package's Pallas kernel in interpret
mode at the JAX tests' tiles tb = 64, tn = 256), trilinear sampling, the ring seed, the
.vti and pooled .npz files, and the replay itself (``advance_density`` at
48^3, its ``start_frame`` resume, and the multi-frame re-trace). Also: the
port's band for its own tiles keeps the guard satisfied on every 512^3
chunk plane of the committed Ring-Collide checkpoints.

Tolerances, stated at each check: f32 sums taken in another order give
~1e-6 of the largest entry; the replay compounds four RK4 stages and a
trilinear sample per step.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_fluids_tpu import FieldSpec, GaussianMixture
from gaussian_fluids_tpu.io import checkpoint as jckpt
from gaussian_fluids_tpu.io import vti as jvti
from gaussian_fluids_tpu.ops import field as jf
from gaussian_fluids_tpu.ops import interp as jinterp
from gaussian_fluids_tpu.solver import simulate3d as jsim

from gaussian_fluids_torch.io import checkpoint as tckpt
from gaussian_fluids_torch.io import vti as tvti
from gaussian_fluids_torch.ops import field as tf
from gaussian_fluids_torch.ops import gsr_banded as tb
from gaussian_fluids_torch.ops import interp as tinterp
from gaussian_fluids_torch.solver import simulate3d as tsim

from torch_parity import close, jax_mixture, jax_mixture_3d, t, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_CKPTS = os.path.join(ROOT, "runs_r2_evidence", "ckpts",
                          "output_3d_ring_collide")


def _grid_queries(n=6, lo=-4.5, hi=4.5):
    g = np.linspace(lo, hi, n).astype(np.float32)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


def _jax_mixture_3d_box(n, seed):
    """tests/test_pallas.py's 3D mixture: seeded shapes in [-5, 5]^3."""
    rng = np.random.RandomState(seed)
    spec = FieldSpec.create((-5,) * 3, (5,) * 3, n, d=3, vdim=3)
    mix = GaussianMixture.create(rng.uniform(-4, 4, (n, 3)), spec)
    sca = mix.scalings + rng.uniform(-0.3, 0.3, mix.scalings.shape) \
        .astype(np.float32)
    rot = jnp.asarray(rng.randn(*mix.rotations.shape), jnp.float32)
    val = (rng.randn(*mix.values.shape)
           * np.asarray(mix.alive)[:, None]).astype(np.float32)
    return GaussianMixture(mix.positions, jnp.asarray(sca), rot,
                           jnp.asarray(val), mix.alive), spec


# ---- the banded value evaluation ----

@pytest.mark.parametrize("case", ["full_band", "narrow_band", "band_1"])
def test_value_banded_matches_pallas(case):
    """Grid-like queries (as in the density backtrace) on an x-sorted
    mixture: the port's plain twin at its kernel's tiles against the JAX
    package's banded kernel at the JAX tests' tiles, each with the whole
    axis as the band, a band one tile short (the guard decides), and band
    1 (the guard must fail and both sweep the whole axis): with a
    sufficient band or a failed guard the result does not depend on the
    tiles. Within 1e-5 of max(1, largest entry): the same f32 terms summed
    in another order."""
    mix, spec = _jax_mixture_3d_box(600, seed=61)
    mix = mix.x_sorted()
    x = _grid_queries()

    def band(tn):
        nnt = -(-mix.capacity // tn)
        return {"full_band": nnt, "narrow_band": nnt - 1, "band_1": 1}[case]

    want = jf.value_banded(mix, spec, jnp.asarray(x), band(256), tb=64,
                           tn=256)
    tm, ts = to_torch(mix, spec)
    got = tf.value_banded(tm, ts, t(x), band(tb.TN))
    close(got, want, 1e-5)
    close(got, jf.value_dense(mix, spec, jnp.asarray(x)), 1e-3)


def test_value_banded_presorted_2d_matches_pallas():
    """d = 2, queries handed in sorted (tests/test_pallas.py
    test_banded_value_presorted)."""
    mix, spec = jax_mixture(100, seed=67)
    mix = mix.x_sorted()
    x = np.random.RandomState(3).uniform(-5, 5, (80, 2)).astype(np.float32)
    xs = x[np.argsort(x[:, 0])]
    want = jf.value_banded(mix, spec, jnp.asarray(xs),
                           -(-mix.capacity // 256), tb=64, tn=256,
                           presorted=True)
    tm, ts = to_torch(mix, spec)
    got = tf.value_banded(tm, ts, t(xs), -(-mix.capacity // tb.TN),
                          presorted=True)
    close(got, want, 1e-5)


def _fast_mix(n=1024, speed=8.0, seed=7):
    """tests/test_band_adversarial.py's fast domain-spanning mixture, at
    N = 1024: no band narrower than the axis covers it."""
    rng = np.random.RandomState(seed)
    spec = FieldSpec.create((-5,) * 3, (5,) * 3, n, d=3, vdim=3)
    mix = GaussianMixture.create(rng.uniform(-4.5, 4.5, (n, 3)), spec)
    vals = jnp.asarray(speed * np.sign(rng.randn(*mix.values.shape))
                       * np.asarray(mix.alive)[:, None], jnp.float32)
    return GaussianMixture(mix.positions, mix.scalings, mix.rotations,
                           vals, mix.alive), spec


def test_value_banded_guard_falls_back_exactly():
    """The guard itself (tests/test_band_adversarial.py:47-69): band 1 on
    an unsorted domain-spanning mixture must fail the device guard, and
    the full sweep must equal the port's own full window bitwise and the
    JAX package's banded call within 1e-5 of the largest entry."""
    mix, spec = _fast_mix()
    rng = np.random.RandomState(13)
    x = rng.uniform(-5, 5, (512, 3)).astype(np.float32)
    tm, ts = to_torch(mix, spec)
    nnt = -(-mix.capacity // tb.TN)
    xs = t(x[np.argsort(x[:, 0], kind="stable")])
    prep = tf.banded_prep(tm, ts)
    x_p = tf._pad_axis(xs, tb.TB)
    assert int(tf.band_window(x_p, 512, prep["nlo"], prep["nhi"], 1,
                              tb.TB)[1]) == 0
    assert int(tf.band_window(x_p, 512, prep["nlo"], prep["nhi"], nnt,
                              tb.TB)[1]) == 1
    got1 = tf.value_banded(tm, ts, t(x), 1)
    gotf = tf.value_banded(tm, ts, t(x), nnt)
    assert torch.equal(got1, gotf)
    want = jf.value_banded(mix, spec, jnp.asarray(x), 1, tb=64, tn=256)
    close(got1, want, 1e-5)


def test_plain_twin_window_and_sweep():
    """The plain twin's own contract: ``ok`` 0 sweeps the whole axis
    whatever ``jlo`` and the band say; ``ok`` 1 sums only the window."""
    mix, spec = _jax_mixture_3d_box(600, seed=62)
    tm, ts = to_torch(mix.x_sorted(), spec)
    prep = tf.banded_prep(tm, ts)
    x = t(np.sort(_grid_queries(8), axis=0)[:2 * tb.TB])
    jlo = torch.zeros(2, dtype=torch.int32)
    nnt = prep["nlo"].shape[0]
    args = (x, prep["muT"], prep["ppT"], prep["v"], ts.clamp_threshold)
    full = tb.value_banded_plain(jlo, torch.ones(1, dtype=torch.int32),
                                 *args, nnt)
    swept = tb.value_banded_plain(jlo, torch.zeros(1, dtype=torch.int32),
                                  *args, 1)
    one = tb.value_banded_plain(jlo, torch.ones(1, dtype=torch.int32),
                                *args, 1)
    assert torch.equal(full, swept)
    close(full, jf.value_dense(mix.x_sorted(), spec, jnp.asarray(x)), 1e-3)
    assert not torch.equal(one, full)   # a one-tile window drops terms


def test_x_sorted_matches():
    mix, spec = jax_mixture_3d(300, seed=5)
    p = mix.params()
    p["positions"] = p["positions"][::-1]
    mix = GaussianMixture(p["positions"], p["scalings"], p["rotations"],
                          p["values"], mix.alive[::-1])
    tm, _ = to_torch(mix, spec)
    got, want = tm.x_sorted(), mix.x_sorted()
    for k in ("positions", "scalings", "rotations", "values", "alive"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))


# ---- the replay's chunk as four stage launches (the kernel's plain twin) ----

_STAGE_GRID, _STAGE_CHUNK, _STAGE_DT = (8, 16, 16), 512, 0.1
_UNIT = (0.0, 1.0, 0.0, 1.0, 0.0, 1.0)
# bands on the 16^3 state's 72 tiles: every tile covered (the suggested
# band), half the tiles of a stage swept, every tile swept
_STAGE_BANDS = {"covering": None, "mixed": 24, "band_1": 1}


@functools.lru_cache(maxsize=1)
def _stage_state():
    """A slab-major Ring-Collide-like state (16^3 Gaussians, capacity 4608,
    72 tiles of the kernel's TN), the replay's chunks of an (8, 16, 16)
    grid over its unit cube (4 chunks of 512 nodes, 4 query tiles each)
    and a seeded density."""
    from gaussian_fluids_torch.utils.seeded_state import ring_collide_state
    mix, spec, _ = ring_collide_state(torch.device("cpu"), seed=4, side=16,
                                      n_queries=64)
    mix = mix.slab_sorted(spec.clamp_threshold)
    xcs, n = tsim._grid_chunks_device(_UNIT, _STAGE_GRID, _STAGE_CHUNK,
                                      torch.device("cpu"))
    dens = torch.rand(_STAGE_GRID, generator=torch.Generator().manual_seed(3))
    band = tsim._suggest_band(mix, spec, _STAGE_DT, chunk=_STAGE_CHUNK)
    return mix, spec, tf.banded_prep(mix, spec), xcs, n, dens, band


def _eager_step(prep, xcs, n, dens, band):
    """The chain the stage launches replace: four host-windowed banded
    evaluations (``value_banded_prepped``) through ``rk4_pos_stages``, the
    clamp and ``trilinear_interp``."""
    lo, hi = torch.tensor(_UNIT[0::2]), torch.tensor(_UNIT[1::2])
    outs = []
    for xc in xcs:
        bk = tsim.rk4_pos_stages(
            lambda q: tf.value_banded_prepped(prep, q, band, presorted=True),
            xc, -_STAGE_DT)
        outs.append(tinterp.trilinear_interp(
            dens, torch.minimum(torch.maximum(bk, lo), hi), _UNIT))
    return torch.cat(outs)[:n]


@pytest.mark.parametrize("case", list(_STAGE_BANDS))
def test_stage_twin_is_the_eager_chain(case):
    """The card's chunk (``_banded_rk4_chunk``: four stage launches, each
    tile on its own window, the last one clamping and sampling into the
    volume) through the plain twin against the eager chain: bitwise where
    every tile is covered, within 1e-6 of the largest value where tiles
    sweep the axis; ``banded_swept_tiles`` counts those tiles, four
    stages of four chunks of four tiles."""
    from gaussian_fluids_torch.utils import profiling
    mix, spec, prep, xcs, n, dens, band = _stage_state()
    band = _STAGE_BANDS[case] or band
    out = torch.full((n,), float("nan"))
    tb.reset_launches()
    with profiling.counting() as rec:
        for i, xc in enumerate(xcs):
            tsim._banded_rk4_chunk(prep, xc, -_STAGE_DT, band, dens, _UNIT,
                                   out, i * _STAGE_CHUNK)
    want = _eager_step(prep, xcs, n, dens, band)
    swept, tiles, calls = rec.sums("banded_swept_tiles")
    assert (tiles, calls) == (4 * len(xcs) * 4, 4 * len(xcs))
    assert tb.launches["gsr_value_banded"] == 0   # the CPU runs the twin
    if case == "covering":
        assert swept == 0
        assert torch.equal(out, want)
    else:
        assert swept == tiles if case == "band_1" else 0 < swept < tiles
        close(out, want.numpy(), 1e-6)
    assert float((out - dens.reshape(-1)).abs().max()) > 1e-3   # it moved


def test_stage_launches_leave_their_points():
    """Each stage's points are a fresh tensor and the launch's ``x`` is
    left as it was (a probe may keep it); the running sum is the eager
    chain's v + 2 v1 + 2 v2 + v3 before the last stage adds v3."""
    mix, spec, prep, xcs, n, dens, band = _stage_state()
    xc = xcs[1]
    f = lambda q: tf.value_banded_prepped(prep, q, band,  # noqa: E731
                                          presorted=True)
    total = torch.empty_like(xc)
    x, vs = xc, []
    for k in range(3):
        before = x.clone()
        nxt = tb.gsr_value_banded(
            None, None, x, prep["muT"], prep["ppT"], prep["v"], prep["rad"],
            prep["lo"], prep["hi"], prep["clamp"], band,
            rk4=tb.RK4Stage(k, -_STAGE_DT, xc, total))
        vs.append(f(x))
        assert nxt.data_ptr() not in (x.data_ptr(), xc.data_ptr())
        assert torch.equal(x, before)
        dt = -_STAGE_DT * (0.5 if k < 2 else 1.0)
        assert torch.equal(nxt, xc + dt * vs[-1])
        x = nxt
    assert torch.equal(total, vs[0] + 2.0 * vs[1] + 2.0 * vs[2])


def test_tile_windows_follow_the_rule():
    """``tile_windows`` against its rule written out tile by tile over
    moved, x-sorted points whose padded rows lie far off (they must not
    widen the last tile's range), and ``field.band_window`` as its
    reduction: the same starts, its guard the conjunction."""
    mix, spec, prep, xcs, n, dens, band = _stage_state()
    rng = np.random.RandomState(5)
    x = torch.cat(xcs)
    x = x + torch.as_tensor(rng.uniform(-0.02, 0.02, x.shape)
                            .astype(np.float32))
    x = x[torch.argsort(x[:, 0], stable=True)]
    b = x.shape[0] - 60
    x[b:] = 100.0
    nlo, nhi = prep["nlo"].numpy(), prep["nhi"].numpy()
    nnt = nlo.shape[0]
    for w in (1, 8, 24, band, nnt):
        jlo, covered = tb.tile_windows(x, b, prep["nlo"], prep["nhi"], w)
        for i in range(x.shape[0] // tb.TB):
            xs = x[i * tb.TB:min((i + 1) * tb.TB, b), 0].numpy()
            meet = np.flatnonzero((nhi >= xs.min()) & (nlo <= xs.max()))
            start = min(max(int(meet[0]) if meet.size else 0, 0), nnt - w)
            assert int(jlo[i]) == start
            assert bool(covered[i]) == (not meet.size
                                        or int(meet[-1]) < start + w)
        hjlo, ok = tf.band_window(x, b, prep["nlo"], prep["nhi"], w, tb.TB)
        assert torch.equal(hjlo, jlo) and int(ok) == int(covered.all())


@pytest.mark.parametrize("band", [24, None])
def test_own_window_sums_match_the_host_window(band):
    """The sums on each tile's own window (``jlo`` None) against the
    host's window (``field.band_window``) on the first stage's points:
    bitwise where the host's guard holds (the suggested band), within
    1e-6 of the largest value where it fails and the host sweeps every
    tile (band 24 on the first two chunks: the first chunk's tiles are
    covered, the second's are not)."""
    mix, spec, prep, xcs, n, dens, sband = _stage_state()
    band = band or sband
    x = torch.cat(xcs[:2])
    args = (x, prep["muT"], prep["ppT"], prep["v"], prep["rad"], prep["lo"],
            prep["hi"], prep["clamp"], band)
    jlo, ok = tf.band_window(x, x.shape[0], prep["nlo"], prep["nhi"], band,
                             tb.TB)
    host = tb.gsr_value_banded(jlo, ok, *args)
    own = tb.gsr_value_banded(None, None, *args)
    covered = tb.tile_windows(x, x.shape[0], prep["nlo"], prep["nhi"],
                              band)[1]
    assert bool(covered.all()) == bool(int(ok)) and bool(covered[0])
    assert float(host.abs().max()) > 0
    if int(ok):
        assert torch.equal(own, host)
    else:
        close(own, host.numpy(), 1e-6)


def test_stage_wrapper_refuses():
    """A stage on the host's window, a stage at vdim 2, points of another
    shape, a half-given window, and a last stage without its density."""
    mix, spec, prep, xcs, n, dens, band = _stage_state()
    x = xcs[0]
    total = torch.empty_like(x)
    args = (prep["muT"], prep["ppT"], prep["v"], prep["rad"], prep["lo"],
            prep["hi"], prep["clamp"], band)
    jlo, ok = tf.band_window(x, x.shape[0], prep["nlo"], prep["nhi"], band,
                             tb.TB)
    st = tb.RK4Stage(0, -0.1, x, total)
    with pytest.raises(ValueError):
        tb.gsr_value_banded(jlo, ok, x, *args, rk4=st)
    with pytest.raises(ValueError):
        tb.gsr_value_banded(None, None, x, prep["muT"], prep["ppT"],
                            prep["v"][:, :2].contiguous(), *args[3:],
                            rk4=st)
    with pytest.raises(ValueError):
        tb.gsr_value_banded(None, None, x, *args,
                            rk4=st._replace(x0=x[:256]))
    with pytest.raises(ValueError):
        tb.gsr_value_banded(jlo, None, x, *args)
    with pytest.raises(ValueError):
        tb.gsr_value_banded(None, None, x, *args, rk4=st._replace(k=3))


# ---- sampling, seeding, files ----

def test_trilinear_interp_matches():
    """Random field and positions across the whole domain, edges
    included: within 1e-6 of max(1, largest entry) (the same f32
    expression)."""
    rng = np.random.RandomState(21)
    f = rng.rand(9, 7, 5).astype(np.float32)
    domain = (-1.0, 2.0, 0.0, 1.0, -0.5, 0.5)
    p = rng.uniform([-1, 0, -0.5], [2, 1, 0.5], (2000, 3)).astype(np.float32)
    p[:8] = [[-1, 0, -0.5], [2, 1, 0.5], [2, 0, -0.5], [-1, 1, 0.5],
             [0.5, 0.5, 0.0], [2, 1, -0.5], [-1, 0, 0.5], [1.25, 0.5, 0.25]]
    want = jinterp.trilinear_interp(jnp.asarray(f), jnp.asarray(p), domain)
    close(tinterp.trilinear_interp(t(f), t(p), domain), want, 1e-6)


@pytest.mark.parametrize("scene", ["ring_collide", "leapfrog"])
def test_seed_ring_density_matches(scene):
    """Every ring of the scene at 48^3: the same solid-torus indicator on
    all but at most 0.01% of the nodes (a node within an f32 rounding of
    the torus surface may land on either side)."""
    from gaussian_fluids_tpu.scenes import get_scene_3d
    sc = get_scene_3d(scene)
    rings = [v for v in sc.info.values() if hasattr(v, "thickness")]
    assert rings
    for r in rings:
        want = np.asarray(jinterp.seed_ring_density(
            (48,) * 3, sc.domain, r.center, r.normal, r.radius, r.thickness))
        got = tinterp.seed_ring_density((48,) * 3, sc.domain, r.center,
                                        r.normal, r.radius,
                                        r.thickness).numpy()
        assert want.sum() > 0
        assert (got != want).sum() <= 1e-4 * want.size


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_vti_round_trip_and_cross_read(tmp_path, writer):
    """A volume written by either package reads back bitwise in both. The
    port's file is the JAX package's native appended-raw file, byte for
    byte; the port also reads the JAX package's inline-base64 fallback."""
    v = np.random.RandomState(1).rand(6, 5, 4).astype(np.float32)
    path = str(tmp_path / "v.vti")
    (tvti if writer == "torch" else jvti).write_vti_array(
        v, (0.0, -1.0, 2.0), (0.1, 0.2, 0.3), path)
    np.testing.assert_array_equal(tvti.read_vti_array(path), v)
    np.testing.assert_array_equal(jvti.read_vti_array(path), v)
    if writer == "torch":
        assert open(path, "rb").read() == _jax_vti(tmp_path, v)
    else:
        _jax_vti(tmp_path, v, native=False)
        np.testing.assert_array_equal(
            tvti.read_vti_array(str(tmp_path / "j.vti")), v)


def _jax_vti(tmp_path, v, native=True):
    """The JAX package's file for the same volume: by its native writer,
    or with ``native`` False by its pure-Python path."""
    from gaussian_fluids_tpu.utils import native as jnative
    path = str(tmp_path / "j.vti")
    orig = jnative.vti_write_f32
    if not native:
        jnative.vti_write_f32 = lambda *a, **k: False
    try:
        jvti.write_vti_array(v, (0.0, -1.0, 2.0), (0.1, 0.2, 0.3), path)
    finally:
        jnative.vti_write_f32 = orig
    return open(path, "rb").read()


def test_write_density_small_matches(tmp_path):
    """The pooled float16 twin: the same arrays as the JAX package's, and
    the refusal of a shape its pool factors do not divide."""
    v = np.random.RandomState(2).rand(96, 48, 128).astype(np.float32)
    args = ((0.0, 0.0, 0.0), (0.01, 0.02, 0.03))
    tsim._write_density_small(v, *args, str(tmp_path / "t.npz"))
    jsim._write_density_small(v, *args, str(tmp_path / "j.npz"))
    got, want = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["density"].shape == (48, 48, 64)
    with pytest.raises(ValueError):
        tsim._write_density_small(v[:, :, :65], *args,
                                  str(tmp_path / "bad.npz"))


# ---- the replay ----

def _tiny_run(out):
    """tests/test_3d.py's 27-Gaussian state in [0, 1]^3, saved as frames
    0 and 1 (one frame with velocity 0.05 along x, one with the values
    doubled)."""
    spec = FieldSpec.create((0, 0, 0), (1, 1, 1), 27, d=3, vdim=3)
    pos = np.stack(np.meshgrid(*([np.linspace(0.2, 0.8, 3)] * 3),
                               indexing="ij"), -1).reshape(-1, 3)
    mix = GaussianMixture.create(pos, spec)
    for i, s in enumerate((0.05, 0.1)):
        m = GaussianMixture(mix.positions, mix.scalings, mix.rotations,
                            mix.values.at[:, 0].set(
                                s * np.asarray(mix.alive)), mix.alive)
        jckpt.save_checkpoint(
            os.path.join(out, f"gaussian_velocity_{i}.pt"), m, spec)


def _replay_close(got, want):
    """Replay volumes: tighter than the JAX package's own step budget
    (tests/test_band_adversarial.py: 99th percentile 1e-3, max 1e-2) —
    max 1e-4 here, the same dense f32 field on both sides."""
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert d.max() <= 1e-4, d.max()


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    """The ring_collide replay at 48^3 over frames 0 and 1 by both
    packages on the CPU, in directories of their own."""
    root = tmp_path_factory.mktemp("replay")
    dirs = {k: str(root / k) for k in ("jax", "torch")}
    for d in dirs.values():
        os.makedirs(d)
        _tiny_run(d)
    jsim.advance_density("ring_collide", dirs["jax"], dt=0.02,
                         grid_res=(48, 48, 48), verbose=0)
    recs = tsim.advance_density("ring_collide", dirs["torch"], dt=0.02,
                                grid_res=(48, 48, 48), verbose=0,
                                device="cpu")
    return dirs, recs


@pytest.mark.parametrize("tag", ["a", "b"])
def test_replay_matches_jax(replays, tag):
    dirs, recs = replays
    assert [r["frame"] for r in recs] == [1, 2]
    assert all(set(r["seconds"]) == {"a", "b"} for r in recs)
    names = sorted(f for f in os.listdir(dirs["jax"]) if "density" in f)
    assert sorted(f for f in os.listdir(dirs["torch"])
                  if "density" in f) == names
    for frame in (0, 1, 2):
        got = tvti.read_vti_array(os.path.join(
            dirs["torch"], f"density_{tag}_{frame}.vti"))
        want = jvti.read_vti_array(os.path.join(
            dirs["jax"], f"density_{tag}_{frame}.vti"))
        _replay_close(got, want)
        small = np.load(os.path.join(dirs["torch"],
                                     f"density_small_{tag}_{frame}.npz"))
        np.testing.assert_allclose(small["density"].astype(np.float32),
                                   got, atol=5e-4)
    d2 = tvti.read_vti_array(os.path.join(dirs["torch"],
                                          f"density_{tag}_2.vti"))
    d0 = tvti.read_vti_array(os.path.join(dirs["torch"],
                                          f"density_{tag}_0.vti"))
    assert d2.max() <= 1 + 1e-5 and d2.sum() > 0
    assert not np.array_equal(d2, d0)   # the field moved the smoke


def test_replay_resume_is_bitwise(replays, tmp_path):
    """``start_frame`` 1 resumes from the replay's own density_*_1.vti and
    gives frame 2 bitwise equal to the uninterrupted replay."""
    dirs, _ = replays
    out = str(tmp_path)
    _tiny_run(out)
    for tag in ("a", "b"):
        v = tvti.read_vti_array(os.path.join(dirs["torch"],
                                             f"density_{tag}_1.vti"))
        tvti.write_vti_array(v, (0, 0, 0), (1, 1, 1),
                             os.path.join(out, f"density_{tag}_1.vti"))
    recs = tsim.advance_density("ring_collide", out, dt=0.02,
                                grid_res=(48, 48, 48), verbose=0,
                                start_frame=1, device="cpu")
    assert [r["frame"] for r in recs] == [2]
    for tag in ("a", "b"):
        np.testing.assert_array_equal(
            tvti.read_vti_array(os.path.join(out, f"density_{tag}_2.vti")),
            tvti.read_vti_array(os.path.join(dirs["torch"],
                                             f"density_{tag}_2.vti")))


def test_advected_density_n_matches(tmp_path):
    """The multi-frame re-trace (tests/test_3d.py
    test_density_retrace_variant's state), port against JAX: within 1e-4
    (the same dense f32 field, two frames of four RK4 stages)."""
    rng = np.random.RandomState(3)
    spec = FieldSpec.create((-2,) * 3, (2,) * 3, 64, d=3, vdim=3)
    mix = GaussianMixture.create(rng.uniform(-1.5, 1.5, (64, 3)), spec)
    mix = GaussianMixture(mix.positions, mix.scalings, mix.rotations,
                          jnp.asarray(rng.randn(*mix.values.shape) * 0.2
                                      * np.asarray(mix.alive)[:, None],
                                      jnp.float32), mix.alive)
    for i in range(2):
        jckpt.save_checkpoint(str(tmp_path / f"gaussian_velocity_{i}.pt"),
                              mix, spec)
    domain = (-2., 2., -2., 2., -2., 2.)
    d0 = np.zeros((12, 12, 12), np.float32)
    d0[4:8, 4:8, 4:8] = 1.0
    want = np.asarray(jsim.advected_density_n(jnp.asarray(d0), str(tmp_path),
                                              domain, 0.05, 2, (12,) * 3,
                                              chunk=1024))
    got = tsim.advected_density_n(t(d0), str(tmp_path), domain, 0.05, 2,
                                  (12,) * 3, chunk=1024).numpy()
    assert np.abs(got - want).max() <= 1e-4
    assert got.sum() > 0


def test_grid_chunks_sorted_padded_and_cached():
    """The replay's grid: grid_points_3d's nodes, padded by the last node
    (so sorted along x), split into chunks, built once per process."""
    from gaussian_fluids_torch.utils.grids import grid_points_3d
    domain = (0.0, 1.0, 0.0, 2.0, 0.0, 1.0)
    dev = torch.device("cpu")
    c1, n1 = tsim._grid_chunks_device(domain, (7, 5, 3), 16, dev)
    c2, _ = tsim._grid_chunks_device(domain, (7, 5, 3), 16, dev)
    pts = torch.cat(c1).numpy()
    assert n1 == 105 and pts.shape[0] % 16 == 0
    assert all(c.shape[0] == 16 for c in c1)
    np.testing.assert_array_equal(pts[:n1], grid_points_3d(*domain, 7, 5, 3))
    assert np.all(pts[n1:] == pts[n1 - 1])
    assert np.all(np.diff(pts[:, 0]) >= 0)
    assert all(a is b for a, b in zip(c1, c2))


@pytest.mark.parametrize("frame", [0, 20])
def test_suggested_band_covers_every_512_plane(frame):
    """On the committed Ring-Collide checkpoints (N = 64,000, capacity
    75,776), the port's band for its kernel's tiles passes the device
    guard for a query tile on every x-plane of the 512^3 grid — each
    production chunk is one such plane — and is well short of the whole
    axis. Computed from tile extents only: no field evaluation."""
    path = os.path.join(RING_CKPTS, f"gaussian_velocity_{frame}.pt")
    mix, spec = tckpt.load_checkpoint(path, device="cpu")
    mix = mix.x_sorted()
    band = tsim._suggest_band(mix, spec, 0.02)
    nlo, nhi = tf.gaussian_tile_extents(mix, spec, tb.TN)
    assert band < nlo.shape[0] // 2
    planes = torch.as_tensor(np.linspace(0, 1, 512, dtype=np.float32))
    x_p = planes.repeat_interleave(tb.TB)[:, None].expand(-1, 3)
    jlo, ok = tf.band_window(x_p, x_p.shape[0], nlo, nhi, band, tb.TB)
    assert int(ok) == 1
    assert int(jlo.min()) >= 0 and int(jlo.max()) <= nlo.shape[0] - band
