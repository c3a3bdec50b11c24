"""ctypes bindings for the native C++ host runtime (native/sobfu_runtime.cpp).

PyTorch-port counterpart of ``sobfu_tpu.native``, with the same surface:
PNG depth decode through libpng, a threaded prefetch ring that decodes and
masks frames ahead while the card runs the solve, and a fast VTK mesh
writer (the reference app's C++ I/O layer, demo.cpp:177-283).

The library is compiled at first use from the same source with the flags
of ``tools/build_native.sh``:

    g++ -O3 -std=c++17 -shared -fPIC -Wall native/sobfu_runtime.cpp \\
        -o sobfu_tpu_torch/_build/libsobfu_runtime_<hash>.so -lpng -lpthread

into this package's git-ignored ``_build/``; the name carries a hash of the
source and flags, as the CUDA library's does (``ops/_build.py``). Where it
cannot be built (no ``g++`` or no libpng headers) every entry point raises
``OSError`` and :func:`available` is False; the build is tried once a
process. This concerns host file decode only: the CLI then decodes on the
Python thread, as ``sobfu_tpu.cli`` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
SRC = PKG_DIR.parent / "native" / "sobfu_runtime.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall")
LIBS = ("-lpng", "-lpthread")

_lib = None
_build_error: Optional[str] = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libsobfu_runtime_{h.hexdigest()[:16]}.so"


def build_native(quiet: bool = False) -> bool:
    """Compile the shared library unless it exists; True on success. The
    output goes to a per-process name first, so concurrent builds never
    load a half-written file."""
    global _build_error
    if not SRC.exists():
        _build_error = f"{SRC} not found"
        return False
    path = _lib_path()
    if path.exists():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS],
            capture_output=True, text=True,
        )
    except OSError as e:
        _build_error = f"g++: {e}"
        return False
    if proc.returncode != 0:
        errors = [ln for ln in proc.stderr.splitlines() if "error" in ln] or ["g++ failed"]
        _build_error = errors[0].strip()
        if not quiet:
            print(proc.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if _build_error is not None or not build_native(quiet=True):
        raise OSError(f"native runtime not built: {_build_error}")
    lib = ctypes.CDLL(str(_lib_path()))
    u16p = ctypes.POINTER(ctypes.c_uint16)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.decode_depth_png.argtypes = [ctypes.c_char_p, u16p, ip, ip]
    lib.decode_depth_png.restype = ctypes.c_int
    lib.apply_mask_png.argtypes = [ctypes.c_char_p, u16p, ctypes.c_int, ctypes.c_int]
    lib.apply_mask_png.restype = ctypes.c_int
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_next.argtypes = [ctypes.c_void_p, u16p, ctypes.c_int, ip, ip]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.write_mesh_vtk.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
    ]
    lib.write_mesh_vtk.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def decode_depth(path: str) -> np.ndarray:
    """16-bit depth PNG -> uint16 [H, W] via libpng."""
    lib = _load()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.decode_depth_png(path.encode(), None, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"decode_depth_png probe failed ({rc}): {path}")
    out = np.empty((h.value, w.value), np.uint16)
    rc = lib.decode_depth_png(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        raise IOError(f"decode_depth_png failed ({rc}): {path}")
    return out


class FrameLoader:
    """Threaded, order-preserving prefetch of depth frames (and optional
    masks: nonzero keeps depth). Worker threads decode ahead while the
    consumer runs the solve; ``capacity`` bounds memory. Iterate to get
    uint16 [H, W] arrays."""

    def __init__(
        self,
        depth_paths: Sequence[str],
        mask_paths: Optional[Sequence[str]] = None,
        capacity: int = 8,
        n_threads: int = 2,
        max_pixels: int = 4096 * 4096,
    ):
        self._h = None
        self._lib = _load()
        self._n = len(depth_paths)
        self._max_pixels = max_pixels
        self._dp = (ctypes.c_char_p * self._n)(*[p.encode() for p in depth_paths])
        self._mp = None
        if mask_paths:
            if len(mask_paths) != self._n:
                raise ValueError(f"{len(mask_paths)} masks for {self._n} depth frames")
            self._mp = (ctypes.c_char_p * self._n)(
                *[(p.encode() if p else None) for p in mask_paths]
            )
        self._h = self._lib.loader_create(self._dp, self._mp, self._n, capacity, n_threads)

    def __iter__(self):
        buf = np.empty(self._max_pixels, np.uint16)
        w, h = ctypes.c_int(), ctypes.c_int()
        while True:
            rc = self._lib.loader_next(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                self._max_pixels, ctypes.byref(w), ctypes.byref(h),
            )
            if rc == 1:
                return
            if rc != 0:
                raise IOError(f"loader_next failed ({rc})")
            yield buf[: h.value * w.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._h:
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def write_mesh_vtk(path: str, vertices: np.ndarray) -> None:
    """Native legacy-ASCII VTK PolyData writer: the bytes of
    ``io.save_mesh_vtk`` for a mesh without colours."""
    lib = _load()
    v = np.ascontiguousarray(vertices, np.float32)
    rc = lib.write_mesh_vtk(
        path.encode(), v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(v.shape[0]),
    )
    if rc != 0:
        raise IOError(f"write_mesh_vtk failed ({rc}): {path}")
