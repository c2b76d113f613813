"""VTK ImageData (.vti) volumes — the JAX package's ``io/vti.py``, with no
vtk dependency.

``write_vti_array`` writes one Float32 point-data scalar array as appended
raw data: an XML header, a UInt32 byte count and the volume x fastest,
byte for byte the file of the JAX package's native writer
(``native/gf_native.cpp``, ``vti_write_f32``), readable by ParaView/VTK.
The volume is put in x-fastest order where it lies (``x_fastest``), so a
card volume is transposed on the card before its copy to the host, and
the payload goes out in one write. ``read_vti_array`` reads these files
and the JAX package's inline-base64 ones. ``write_vti_field`` evaluates a
field on the nodes of a grid, on the device of the caller's choice, and
writes it.
"""

from __future__ import annotations

import base64
import re
import struct

import numpy as np
import torch

from gaussian_fluids_torch.utils.grids import grid_nodes

_TAIL = b"\n  </AppendedData>\n</VTKFile>\n"


def _header(shape, origin, spacing, name: str) -> bytes:
    """The XML before the payload, with the native writer's ``%.9g``
    numbers."""
    nx, ny, nz = shape
    extent = f"0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"
    o = " ".join("%.9g" % float(v) for v in origin)
    s = " ".join("%.9g" % float(v) for v in spacing)
    return (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="ImageData" version="0.1" '
        'byte_order="LittleEndian" header_type="UInt32">\n'
        f'  <ImageData WholeExtent="{extent}" '
        f'Origin="{o}" Spacing="{s}">\n'
        f'    <Piece Extent="{extent}">\n'
        f'      <PointData Scalars="{name}">\n'
        f'        <DataArray type="Float32" Name="{name}" '
        'format="appended" offset="0"/>\n'
        '      </PointData>\n'
        '      <CellData></CellData>\n'
        '    </Piece>\n'
        '  </ImageData>\n'
        '  <AppendedData encoding="raw">\n_').encode()


def x_fastest(V):
    """The (nz, ny, nx) C-contiguous f32 copy of the (nx, ny, nz) volume
    ``V``, made where ``V`` lies: a tensor stays a tensor on its device,
    anything else becomes a numpy array."""
    if isinstance(V, torch.Tensor):
        return V.float().permute(2, 1, 0).contiguous()
    return np.ascontiguousarray(np.asarray(V, np.float32).transpose(2, 1, 0))


def write_vti_array(V, origin, spacing, save_filename: str,
                    name: str = "scalars") -> None:
    """Writes the (nx, ny, nz) scalar volume ``V`` (a numpy array, or a
    tensor on any device)."""
    F = x_fastest(V)
    if isinstance(F, torch.Tensor):
        F = F.cpu().numpy()
    write_vti_x_fastest(F, origin, spacing, save_filename, name)


def write_vti_x_fastest(F: np.ndarray, origin, spacing, save_filename: str,
                        name: str = "scalars") -> None:
    """Writes the volume whose (nz, ny, nx) C-contiguous f32 host copy
    (``x_fastest``) is ``F``."""
    F = np.ascontiguousarray(F, np.float32)
    if F.nbytes > 0xFFFFFFFF:
        raise ValueError(f"a {F.shape[::-1]} f32 volume overflows the "
                         "UInt32 byte count of a .vti payload")
    with open(save_filename, "wb") as fd:
        fd.write(_header(F.shape[::-1], origin, spacing, name))
        fd.write(struct.pack("<I", F.nbytes))
        fd.write(F.data)
        fd.write(_TAIL)


def read_vti_array(path: str) -> np.ndarray:
    """The (nx, ny, nz) f32 volume of a file written by either package
    (appended raw data, or the JAX package's inline base64)."""
    with open(path, "rb") as fd:
        blob = fd.read()
    text = blob.decode("latin-1")
    extent = [int(t) for t in
              re.search(r'WholeExtent="([^"]+)"', text).group(1).split()]
    nx, ny, nz = extent[1] + 1, extent[3] + 1, extent[5] + 1
    m = re.search(r'format="binary">\s*([A-Za-z0-9+/=]+)\s*<', text)
    if m:
        raw = base64.b64decode(m.group(1))
    else:
        start = blob.index(b'encoding="raw">')
        start = blob.index(b"_", start) + 1
        raw = blob[start:]
    (nbytes,) = struct.unpack("<I", raw[:4])
    data = np.frombuffer(raw[4:4 + nbytes], np.float32)
    return data.reshape((nx, ny, nz), order="F")


def field_spacing(domain, shape):
    """The spacing ``write_vti_field`` writes: extent / n per axis over
    endpoint-inclusive nodes (not / (n - 1)), the reference's convention
    verbatim (reference 3D/GSR.py:737), kept for parity of the files
    though it draws the volume (n - 1) / n compressed toward the origin."""
    return tuple((domain[2 * i + 1] - domain[2 * i]) / n
                 for i, n in enumerate(shape))


def grid_values(field_fn, domain, shape, chunk: int = 65536,
                device="cpu") -> torch.Tensor:
    """``field_fn`` ((c, 3) f32 points -> (c,) or (c, k)) on the nodes of
    the ``shape`` grid over ``domain`` (``utils.grids.grid_points_3d``'s
    nodes and order, built on ``device``), in chunks of ``chunk`` points:
    a (nx, ny, nz) or (nx, ny, nz, k) f32 tensor on ``device``."""
    pts = grid_nodes(domain, shape, device)
    out = torch.cat([field_fn(c).float() for c in pts.split(chunk)])
    return out.reshape(*shape, *out.shape[1:])


def write_vti_field(field_fn, domain, save_filename: str, x_n=30, y_n=30,
                    z_n=30, chunk: int = 65536, device="cpu") -> None:
    """Evaluates the scalar ``field_fn`` ((c, 3) points -> (c,)) on the
    grid (``grid_values``) and writes it (reference 3D/GSR.py:728-742)."""
    shape = (x_n, y_n, z_n)
    V = grid_values(field_fn, domain, shape, chunk, device)
    write_vti_array(V, domain[0::2], field_spacing(domain, shape),
                    save_filename)
