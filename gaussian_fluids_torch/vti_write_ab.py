"""The replay's 512^3 ``.vti`` write, timed for three writers in
alternated order in one run.

    python -m gaussian_fluids_torch.vti_write_ab [--rounds 6] [--n 512]

The volume is the Ring-Collide seed density at n^3 on the card
(``interp.seed_ring_density``). Each round writes it once with each
writer, to a file of its own, in an order that rotates and reverses from
round to round, so each writer comes first, in the middle and last:

- ``python_raw``: the port's writer (``io/vti.write_vti_array``'s path):
  transposed to x-fastest on the card, copied to the host, written as
  appended raw data in one call;
- ``cpp_raw``: the JAX package's native writer (``native/gf_native.cpp``,
  ``vti_write_f32``, built here with ``g++ -O3 -shared -fPIC`` into the
  temporary directory): copied to the host as it lies, gathered x-fastest
  and written by the C++ loop, as the same appended raw bytes;
- ``base64``: the JAX package's pure-Python inline-base64 path, on the
  same host copy.

Each write's seconds are taken to the file's close (``seconds``, the
figure the replay's writer records), the card-to-host copy apart
(``copy_seconds``) and the ``os.fsync`` after it apart (``fsync_seconds``);
the file is deleted before the next write. Round 0 checks that the two raw
files are the same bytes and that every file reads back to the volume.
Prints one JSON line per write, one summary line with each writer's
median, min, max and spread ((max - min) / median) over the rounds, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import base64
import ctypes
import json
import os
import statistics
import struct
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "gf_native.cpp"
WRITERS = ("python_raw", "cpp_raw", "base64")


def _cpp_writer(tmp: str):
    """``vti_write_f32`` of the C++ source, built into ``tmp``."""
    lib_path = os.path.join(tmp, "gf_native.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(SOURCE), "-o",
                    lib_path], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    fn = lib.vti_write_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                   ctypes.POINTER(ctypes.c_double),
                   ctypes.POINTER(ctypes.c_double), ctypes.c_char_p]

    def write(V, origin, spacing, path):
        o = (ctypes.c_double * 3)(*map(float, origin))
        s = (ctypes.c_double * 3)(*map(float, spacing))
        if fn(path.encode(), V.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
              *V.shape, o, s, b"scalars") != 0:
            raise RuntimeError(f"vti_write_f32 failed on {path}")
    return write


def _base64_write(V, origin, spacing, path):
    """The JAX package's pure-Python inline-base64 file."""
    nx, ny, nz = V.shape
    raw = V.ravel(order="F").tobytes()
    payload = base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()
    extent = f"0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"
    with open(path, "w") as fd:
        fd.write(
            '<?xml version="1.0"?>\n'
            '<VTKFile type="ImageData" version="0.1" '
            'byte_order="LittleEndian" header_type="UInt32">\n'
            f'  <ImageData WholeExtent="{extent}" '
            f'Origin="{" ".join(map(str, origin))}" '
            f'Spacing="{" ".join(map(str, spacing))}">\n'
            f'    <Piece Extent="{extent}">\n'
            '      <PointData Scalars="scalars">\n'
            '        <DataArray type="Float32" Name="scalars" '
            'format="binary">\n'
            f'          {payload}\n'
            '        </DataArray>\n'
            '      </PointData>\n'
            '      <CellData></CellData>\n'
            '    </Piece>\n'
            '  </ImageData>\n'
            '</VTKFile>\n')


def _order(r: int):
    k = r % len(WRITERS)
    order = WRITERS[k:] + WRITERS[:k]
    return order[::-1] if (r // len(WRITERS)) % 2 else order


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--dir", default=None,
                    help="where the temporary files go (default: the "
                         "working directory)")
    args = ap.parse_args(argv)

    import torch

    from gaussian_fluids_torch.io import vti
    from gaussian_fluids_torch.ops import interp
    from gaussian_fluids_torch.scenes import get_scene_3d

    if not torch.cuda.is_available():
        raise SystemExit("vti_write_ab: no CUDA device")
    dev = torch.device("cuda")
    scene = get_scene_3d("ring_collide")
    domain, r = scene.domain, scene.info["ring1"]
    shape = (args.n,) * 3
    vol = interp.seed_ring_density(shape, domain, r.center, r.normal,
                                   r.radius, r.thickness, device=dev)
    torch.cuda.synchronize()
    origin = tuple(domain[0::2])
    spacing = tuple((domain[2 * i + 1] - domain[2 * i]) / args.n
                    for i in range(3))
    expect = vol.cpu().numpy()
    runs = {w: [] for w in WRITERS}
    with tempfile.TemporaryDirectory(dir=args.dir or os.getcwd()) as tmp:
        cpp_write = _cpp_writer(tmp)
        for rnd in range(args.rounds):
            kept = {}
            for w in _order(rnd):
                path = os.path.join(tmp, f"{w}_{rnd}.vti")
                t0 = time.perf_counter()
                if w == "python_raw":
                    host = vti.x_fastest(vol).cpu().numpy()
                else:
                    host = vol.cpu().numpy()
                t1 = time.perf_counter()
                if w == "python_raw":
                    vti.write_vti_x_fastest(host, origin, spacing, path)
                elif w == "cpp_raw":
                    cpp_write(host, origin, spacing, path)
                else:
                    _base64_write(host, origin, spacing, path)
                t2 = time.perf_counter()
                fd = os.open(path, os.O_RDONLY)
                os.fsync(fd)
                os.close(fd)
                t3 = time.perf_counter()
                rec = {"round": rnd, "writer": w, "copy_seconds": t1 - t0,
                       "seconds": t2 - t1, "fsync_seconds": t3 - t2,
                       "bytes": os.path.getsize(path)}
                runs[w].append(rec)
                print(json.dumps(rec), flush=True)
                del host
                if rnd == 0:
                    if not np.array_equal(vti.read_vti_array(path), expect):
                        raise AssertionError(f"{w}: the file does not read "
                                             "back to the volume")
                    if w != "base64":
                        kept[w] = Path(path).read_bytes()
                os.remove(path)
            if rnd == 0 and kept["python_raw"] != kept["cpp_raw"]:
                raise AssertionError("the two raw writers' files differ")
            kept.clear()

    def stats(xs):
        med = statistics.median(xs)
        return {"median": med, "min": min(xs), "max": max(xs),
                "spread": (max(xs) - min(xs)) / med if med else None,
                "all": xs}
    summary = {"n": args.n, "rounds": args.rounds, "raw_identical": True}
    for w in WRITERS:
        summary[w] = {k: stats([rec[k] for rec in runs[w]]) for k in
                      ("seconds", "copy_seconds", "fsync_seconds")}
        summary[w]["bytes"] = runs[w][0]["bytes"]
    print(json.dumps(summary), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
