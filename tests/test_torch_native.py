"""The port's native host runtime (sobfu_tpu_torch.native): decode, the
prefetch loader and the VTK writer, from tests/test_native.py, against the
port's Python readers and writer.

The library is built from native/sobfu_runtime.cpp into the port's
``_build/``; the tests skip only where it cannot be built (no ``g++`` or
no libpng), as the JAX package's do.
"""

import os

import numpy as np
import pytest

from sobfu_tpu_torch import io as tio
from sobfu_tpu_torch import native
from sobfu_tpu_torch.mc import Mesh


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"native runtime not built: {native._build_error}")
    return native


def _write_png16(path, arr):
    from PIL import Image

    Image.fromarray(arr.astype(np.int32), mode="I").convert("I;16").save(path)


def test_library_builds_into_the_port(lib):
    path = lib._lib_path()
    assert path.exists() and path.parent == lib.PKG_DIR / "_build"
    assert path.name.startswith("libsobfu_runtime_") and path.suffix == ".so"
    repo = lib.PKG_DIR.parent
    assert not os.path.relpath(path, repo).startswith("sobfu_tpu" + os.sep)


def test_decode_depth_roundtrip(lib, tmp_path):
    d = np.random.default_rng(0).integers(0, 5000, (48, 64)).astype(np.uint16)
    p = str(tmp_path / "d.png")
    _write_png16(p, d)
    out = lib.decode_depth(p)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, d)
    np.testing.assert_array_equal(out, tio.load_depth(p))


def test_loader_preserves_order_and_content(lib, tmp_path):
    base = np.random.default_rng(1).integers(0, 1000, (32, 40)).astype(np.uint16)
    paths = []
    for i in range(7):
        paths.append(str(tmp_path / f"f{i}.png"))
        _write_png16(paths[-1], base + i)
    frames = list(lib.FrameLoader(paths, capacity=2, n_threads=3))
    assert len(frames) == 7
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(f, base + i)


def test_loader_applies_masks_as_python_does(lib, tmp_path):
    rng = np.random.default_rng(2)
    dp, mp = [], []
    for i in range(3):
        dp.append(str(tmp_path / f"d{i}.png"))
        mp.append(str(tmp_path / f"m{i}.png"))
        _write_png16(dp[-1], rng.integers(1, 3000, (16, 24)))
        _write_png16(mp[-1], (rng.random((16, 24)) > 0.5) * 255)
    for i, frame in enumerate(lib.FrameLoader(dp, mp)):
        want = tio.apply_mask(tio.load_depth(dp[i]), tio.load_mask(mp[i]))
        np.testing.assert_array_equal(frame, want)
        assert (frame == 0).any() and (frame > 0).any()


def test_loader_rejects_unpaired_masks(lib, tmp_path):
    with pytest.raises(ValueError, match="masks"):
        lib.FrameLoader(["a.png", "b.png"], ["m.png"])


def test_native_vtk_bytes_equal_the_python_writer(lib, tmp_path):
    v = np.random.default_rng(2).standard_normal((12, 3)).astype(np.float32)
    a, b = str(tmp_path / "native.vtk"), str(tmp_path / "python.vtk")
    lib.write_mesh_vtk(a, v)
    tio.save_mesh_vtk(Mesh(vertices=v, normals=np.zeros_like(v)), b)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_allclose(tio.load_mesh_vtk(a).vertices, v, rtol=1e-5, atol=1e-6)
