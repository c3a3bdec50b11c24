"""Build and load the CUDA kernels of ``sobfu_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``. Each source compiles in its
own ``nvcc`` process, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \\
         -Xcompiler -fPIC -c csrc/<name>.cu -o _build/<hash>/<name>.o   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libsobfu_kernels_<hash>.so _build/<hash>/*.o

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu; every entry point returns cudaGetLastError()
SIGNATURES = {
    "sobfu_warp": (_P, _I, _P, _P, _I, _I, _I, _I, ctypes.c_uint, _P),
    "sobfu_inverse_fixed_point": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "sobfu_warp_fuse": (_P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _P),
    "sobfu_gd_iterations": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F,
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "sobfu_gd_multi": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _I, _I, _F,
        _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "sobfu_compose_weight": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "sobfu_gd_slab_iterations": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F,
        _P, _P, _P, _I, _I, _P, _P, _I,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "sobfu_preprocess_depth": (_P, _P, _I, _I, _I, ctypes.c_double, _F, _I, _P, _P),
    "sobfu_integrate_dists": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
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


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build(verbose: bool = False) -> tuple:
    """Compile the library unless it exists; returns (path, compiler log).

    verbose adds ``-Xptxas -v`` (registers, shared memory and spills per
    kernel) to a build that actually runs.
    """
    digest = source_hash()
    lib_path = BUILD_DIR / f"libsobfu_kernels_{digest}.so"
    if lib_path.exists():
        return lib_path, ""
    obj_dir = BUILD_DIR / f"{digest}.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    srcs = sorted(SRC_DIR.glob("*.cu"))
    objs = [obj_dir / f"{src.stem}.o" for src in srcs]
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        logs = list(pool.map(
            lambda so: _run([nvcc, *NVCC_FLAGS, *extra, "-c", str(so[0]), "-o", str(so[1])]),
            zip(srcs, objs),
        ))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    logs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]))
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib_path, "".join(logs)


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
