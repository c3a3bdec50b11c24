"""I/O: depth/colour/mask loading, VTK mesh and VTI field export and
their readers.

PyTorch-port counterpart of ``sobfu_tpu.io`` (pure Python + PIL). Formats
are the reference app's (src/apps/demo.cpp:177-283): legacy ``.vtk``
PolyData meshes, XML ``.vti`` displacement fields, 16-bit PNG depth in
millimetres masked by optional ``omask`` images. The readers take what
either package writes. Decoding here is always Python's: the CLI's native
prefetch loader is :mod:`sobfu_tpu_torch.native`.
"""

from __future__ import annotations

import os
import re
import struct
from typing import List, Tuple

import numpy as np

from sobfu_tpu_torch.mc import Mesh


def load_depth(path: str) -> np.ndarray:
    """Load a 16-bit depth PNG (mm) -> uint16 [H, W]."""
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint16)


def load_color(path: str) -> np.ndarray:
    """Colour image -> uint8 [H, W, 3] RGB."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def load_mask(path: str) -> np.ndarray:
    """Object mask: nonzero pixels keep depth (demo.cpp:314-330)."""
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr > 0


def apply_mask(depth: np.ndarray, mask: np.ndarray) -> np.ndarray:
    return np.where(mask, depth, 0).astype(np.uint16)


def list_frames(data_dir: str) -> Tuple[List[str], List[str], List[str]]:
    """Sorted depth/color/mask file lists of a reference-layout scene dir
    (<dir>/depth, <dir>/color, optional <dir>/omask; demo.cpp:177-198)."""
    depth_dir = os.path.join(data_dir, "depth")
    color_dir = os.path.join(data_dir, "color")
    if not os.path.isdir(depth_dir) or not os.path.isdir(color_dir):
        raise FileNotFoundError(
            f"source directory {data_dir} should contain 'color' and 'depth' folders"
        )

    def listing(d):
        return sorted(os.path.join(d, f) for f in os.listdir(d) if not f.startswith("."))

    mask_dir = os.path.join(data_dir, "omask")
    masks = listing(mask_dir) if os.path.isdir(mask_dir) else []
    return listing(depth_dir), listing(color_dir), masks


def save_mesh_vtk(mesh: Mesh, path: str, binary: bool = False) -> None:
    """Write a triangle mesh as legacy VTK PolyData: POINTS + POLYGONS (the
    pcl::io::saveVTKFile contract, demo.cpp:237-246), ASCII or big-endian
    binary, and per-vertex RGB as COLOR_SCALARS where ``mesh.colors`` is
    set. The bytes are ``sobfu_tpu.io.save_mesh_vtk``'s Python writer's."""
    v = np.asarray(mesh.vertices, dtype=np.float32)
    colors = getattr(mesh, "colors", None)
    n_pts = v.shape[0]
    n_tri = n_pts // 3
    polys = np.arange(n_tri * 3, dtype=np.int32).reshape(-1, 3)
    cells = np.hstack([np.full((n_tri, 1), 3, np.int32), polys])
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\n")
        f.write(b"sobfu_tpu mesh\n")
        f.write(b"BINARY\n" if binary else b"ASCII\n")
        f.write(b"DATASET POLYDATA\n")
        f.write(f"POINTS {n_pts} float\n".encode())
        if binary:
            f.write(v.astype(">f4").tobytes() + b"\n")
        else:
            np.savetxt(f, v, fmt="%.6g")
        f.write(f"POLYGONS {n_tri} {n_tri * 4}\n".encode())
        if binary:
            f.write(cells.astype(">i4").tobytes() + b"\n")
        else:
            np.savetxt(f, cells, fmt="%d")
        if colors is not None and n_pts:
            f.write(f"POINT_DATA {n_pts}\nCOLOR_SCALARS rgb 3\n".encode())
            if binary:  # the uint8 bytes as they are: a float round trip can lose one
                f.write(np.asarray(colors, np.uint8).tobytes() + b"\n")
            else:
                np.savetxt(f, np.asarray(colors, np.float32) / 255.0, fmt="%.4f")


def save_field_vti(field_disp: np.ndarray, path: str, spacing=(1.0, 1.0, 1.0)) -> None:
    """Write a displacement field f32[3, Z, Y, X] as an XML .vti file with a
    3-component 'displacement' array (appended raw, little endian)."""
    C, Z, Y, X = field_disp.shape
    if C != 3:
        raise ValueError(f"expected a 3-channel field, got {C} channels")
    data = np.ascontiguousarray(np.moveaxis(np.asarray(field_disp), 0, -1), dtype="<f4")
    raw = data.tobytes()
    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0"?>\n')
        f.write(
            b'<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian" '
            b'header_type="UInt64">\n'
        )
        f.write(
            f'<ImageData WholeExtent="0 {X - 1} 0 {Y - 1} 0 {Z - 1}" '
            f'Origin="0 0 0" Spacing="{spacing[0]} {spacing[1]} {spacing[2]}">\n'.encode()
        )
        f.write(f'<Piece Extent="0 {X - 1} 0 {Y - 1} 0 {Z - 1}">\n'.encode())
        f.write(b'<PointData Vectors="displacement">\n')
        f.write(
            b'<DataArray type="Float32" Name="displacement" NumberOfComponents="3" '
            b'format="appended" offset="0"/>\n'
        )
        f.write(b"</PointData>\n<CellData/>\n</Piece>\n</ImageData>\n")
        f.write(b'<AppendedData encoding="raw">\n_')
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        f.write(b"\n</AppendedData>\n</VTKFile>\n")


def load_mesh_vtk(path: str) -> Mesh:
    """Read a legacy VTK PolyData triangle soup as :func:`save_mesh_vtk`
    (or the native writer, or ``sobfu_tpu.io``) writes it: ASCII or binary
    POINTS, and COLOR_SCALARS as uint8 colours where present. Normals are
    not stored and come back as zeros. ASCII points parse through float64,
    as ``sobfu_tpu.io.load_mesh_vtk`` parses them."""
    with open(path, "rb") as f:
        blob = f.read()
    lines = blob.split(b"\n", 4)
    if len(lines) < 5 or not lines[0].startswith(b"# vtk"):
        raise ValueError(f"{path}: not a legacy VTK file")
    binary = lines[2].strip().upper() == b"BINARY"
    reader = _BinaryVtk(blob, len(blob) - len(lines[4])) if binary else _AsciiVtk(lines[4])
    pts = colors = None
    for key, args in reader.sections():
        if key == "POINTS":
            n = int(args[0])
            pts = reader.values(3 * n, ">f4", np.float64).astype(np.float32).reshape(n, 3)
        elif key == "POLYGONS":
            reader.values(int(args[1]), ">i4", np.int64)  # the soup's implicit 3-cycles
        elif key == "COLOR_SCALARS":
            n = 0 if pts is None else pts.shape[0]
            c = reader.values(n * int(args[1]), "u1", np.float64).reshape(n, -1)
            colors = c.astype(np.uint8) if binary else np.rint(c * 255.0).astype(np.uint8)
    if pts is None:
        raise ValueError(f"no POINTS in {path}")
    return Mesh(vertices=pts, normals=np.zeros_like(pts), colors=colors)


class _AsciiVtk:
    """Sections of an ASCII legacy VTK body: whitespace-separated tokens."""

    def __init__(self, body: bytes):
        self.tok = body.split()
        self.i = 0

    def sections(self):
        while self.i < len(self.tok):
            key = self.tok[self.i].decode()
            self.i += 1
            if key in ("POINTS", "POLYGONS", "COLOR_SCALARS"):  # two words follow each
                args = [t.decode() for t in self.tok[self.i:self.i + 2]]
                self.i += 2
                yield key, args

    def values(self, n, _binary_dtype, dtype):
        out = np.asarray(self.tok[self.i:self.i + n], dtype=dtype)
        self.i += n
        return out


class _BinaryVtk:
    """Sections of a binary legacy VTK body: keyword lines, then big-endian
    arrays each followed by a newline."""

    def __init__(self, blob: bytes, pos: int):
        self.blob, self.pos = blob, pos

    def sections(self):
        while self.pos < len(self.blob):
            end = self.blob.find(b"\n", self.pos)
            end = len(self.blob) if end < 0 else end
            words = self.blob[self.pos:end].decode("ascii", "replace").split()
            self.pos = end + 1
            if words:
                yield words[0], words[1:]

    def values(self, n, binary_dtype, dtype):
        out = np.frombuffer(self.blob, binary_dtype, n, self.pos).astype(dtype)
        self.pos += out.size * np.dtype(binary_dtype).itemsize
        if self.blob[self.pos:self.pos + 1] == b"\n":
            self.pos += 1
        return out


def load_field_vti(path: str) -> np.ndarray:
    """Read a displacement field written by :func:`save_field_vti` (or
    ``sobfu_tpu.io.save_field_vti``) back as f32[3, Z, Y, X]."""
    with open(path, "rb") as f:
        blob = f.read()
    head, _, rest = blob.partition(b'<AppendedData encoding="raw">\n_')
    m = re.search(rb'WholeExtent="0 (\d+) 0 (\d+) 0 (\d+)"', head)
    if m is None or len(rest) < 8:
        raise ValueError(f"{path}: not a displacement .vti")
    X, Y, Z = (int(m.group(i)) + 1 for i in (1, 2, 3))
    (n_bytes,) = struct.unpack("<Q", rest[:8])
    data = np.frombuffer(rest[8:8 + n_bytes], dtype="<f4")
    if data.size != 3 * X * Y * Z:
        raise ValueError(f"{path}: {data.size} values for a 3 x {Z} x {Y} x {X} field")
    return np.moveaxis(data.reshape(Z, Y, X, 3), -1, 0).astype(np.float32)
