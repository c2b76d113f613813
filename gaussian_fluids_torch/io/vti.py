"""VTK ImageData (.vti) volumes — the JAX package's ``io/vti.py``, pure
Python with no vtk dependency.

``write_vti_array`` writes the inline-base64 encoding (an XML ImageData
file with one Float32 point-data scalar array, Fortran-ordered, x fastest,
with a UInt32 byte-count header), readable by ParaView/VTK and by both
packages' ``read_vti_array``. The JAX package's native appended-raw writer
(``native/gf_native.so``) waits for the port's loader of that library;
either encoding holds the same lossless f32 volume. ``read_vti_array``
reads both encodings. ``write_vti_field`` is not ported yet.
"""

from __future__ import annotations

import base64
import re
import struct

import numpy as np


def write_vti_array(V: np.ndarray, origin, spacing, save_filename: str,
                    name: str = "scalars") -> None:
    """V: (nx, ny, nz) scalar volume."""
    V = np.ascontiguousarray(np.asarray(V, np.float32))
    nx, ny, nz = V.shape
    raw = V.ravel(order="F").tobytes()
    payload = base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()
    extent = f"0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"
    ox, oy, oz = origin
    sx, sy, sz = spacing
    with open(save_filename, "w") as fd:
        fd.write(
            '<?xml version="1.0"?>\n'
            '<VTKFile type="ImageData" version="0.1" '
            'byte_order="LittleEndian" header_type="UInt32">\n'
            f'  <ImageData WholeExtent="{extent}" '
            f'Origin="{ox} {oy} {oz}" Spacing="{sx} {sy} {sz}">\n'
            f'    <Piece Extent="{extent}">\n'
            f'      <PointData Scalars="{name}">\n'
            f'        <DataArray type="Float32" Name="{name}" '
            'format="binary">\n'
            f'          {payload}\n'
            '        </DataArray>\n'
            '      </PointData>\n'
            '      <CellData></CellData>\n'
            '    </Piece>\n'
            '  </ImageData>\n'
            '</VTKFile>\n')


def read_vti_array(path: str) -> np.ndarray:
    """The (nx, ny, nz) f32 volume of a file written by either package
    (inline base64, or the native writer's appended raw data)."""
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
