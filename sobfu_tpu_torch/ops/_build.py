"""Build and load the CUDA kernels of ``sobfu_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \\
         -shared -Xcompiler -fPIC -o _build/libsobfu_kernels_<hash>.so csrc/*.cu

The library name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. ``--fmad=false``
keeps each multiply and add separately rounded, as in the plain torch
versions; ``--use_fast_math`` is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu; every entry point returns cudaGetLastError()
SIGNATURES = {
    "sobfu_warp": (_P, _I, _P, _P, _I, _I, _I, _I, ctypes.c_uint, _P),
    "sobfu_inverse_fixed_point": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "sobfu_warp_fuse": (_P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _P),
    "sobfu_gd_iteration": (
        _P, _P, _P, _P, _P, _P, _I, _F, _F, _F,
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(verbose: bool = False) -> tuple:
    """Compile the library unless it exists; returns (path, compiler log).

    verbose adds ``-Xptxas -v`` (registers, shared memory and spills per
    kernel) to a build that actually runs.
    """
    lib_path = BUILD_DIR / f"libsobfu_kernels_{source_hash()}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp)] + [str(p) for p in sorted(SRC_DIR.glob("*.cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
