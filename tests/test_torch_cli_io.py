"""The port's command line, writers and readers against the JAX package's.

  - the two parsers accept the same argv, every flag of ``sobfu_tpu/cli.py``
    included, and parse it to the same values (the port's --device apart);
  - ``--live-viz-port`` and ``--live-viz-host`` take effect with
    ``--live-viz`` and are inert without it;
  - ``save_mesh_vtk`` writes the bytes of ``sobfu_tpu.io.save_mesh_vtk``'s
    Python writer (the native writer is pinned off in this test only), ASCII
    and binary, with and without per-vertex colours;
  - the readers round-trip both packages' files: ``load_mesh_vtk`` reads the
    JAX writers' meshes (its Python writer, ASCII and binary, with and
    without colours, and its native writer) to the arrays JAX's reader
    gives, and JAX's ASCII reader reads the port's; ``load_field_vti`` and
    JAX's read each other's fields bit for bit; ``load_color`` is JAX's.
"""

import numpy as np
import pytest

from sobfu_tpu import cli as jcli
from sobfu_tpu import io as jio
from sobfu_tpu import native as jnative
from sobfu_tpu.mc import Mesh as JMesh
from sobfu_tpu_torch import cli as tcli
from sobfu_tpu_torch import io as tio
from sobfu_tpu_torch.mc import Mesh as TMesh
from sobfu_tpu_torch.viewer import LiveViewer
from tests.test_torch_pipeline import make_synthetic_scene

ARGVS = [
    ["scene", "p.ini"],
    ["scene", "p.ini", "--live-viz-port", "9001", "--live-viz-host", "0.0.0.0"],
    ["scene", "p.ini", "--no-native-loader", "--enable-log", "--max-frames", "3", "--vverbose"],
    ["scene", "p.ini", "--verbose", "--live-viz-port=1234", "--no-native-loader"],
    ["scene", "p.ini", "--enable-viz", "--enable-viz-detailed", "--color-mesh", "--live-viz"],
    ["scene", "p.ini", "--checkpoint", "c.npz", "--resume", "r.npz", "--enable-log"],
    ["scene", "p.ini", "--enable-viz", "--enable-viz-detailed", "--enable-log", "--verbose",
     "--vverbose", "--max-frames", "9", "--color-mesh", "--live-viz", "--live-viz-port", "0",
     "--live-viz-host", "::1", "--checkpoint=c.npz", "--resume=c.npz", "--no-native-loader"],
]


def test_argvs_cover_every_flag():
    flags = {a.split("=")[0] for argv in ARGVS for a in argv if a.startswith("--")}
    jax_flags = {o for a in jcli.build_argparser()._actions for o in a.option_strings}
    assert flags == jax_flags - {"-h", "--help"}


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parsers_accept_the_same_argv(argv):
    want = vars(jcli.build_argparser().parse_args(argv))
    got = vars(tcli.build_argparser().parse_args(argv))
    assert got.pop("device") == "cuda"  # the port's own flag
    assert got == want


def _tiny_scene(tmp_path):
    scene = tmp_path / "scene"
    make_synthetic_scene.main([str(scene), "--frames", "3", "--dim", "16", "--width", "64",
                               "--height", "48"])
    ini = scene / "params.ini"
    ini.write_text(ini.read_text() + "MAX_ITER=4\n")
    return str(scene), str(ini)


def test_viewer_flags_are_inert_without_live_viz(tmp_path, monkeypatch):
    """With --live-viz the viewer starts on --live-viz-port and
    --live-viz-host, gets each solved frame and stops at the end, and the
    inverse warps are computed per frame; without it the two flags start
    nothing."""
    started = []

    class Viewer(LiveViewer):
        def __init__(self, port, host):
            super().__init__(port=port, host=host)
            started.append(self)
            self.frames = []

        def update(self, fusion, **kw):
            super().update(fusion, **kw)
            self.frames.append((kw["frame"], fusion.need_inv_warps))

    monkeypatch.setattr(tcli, "LiveViewer", Viewer)
    scene, ini = _tiny_scene(tmp_path)
    base = [scene, ini, "--device", "cpu", "--live-viz-port", "0", "--live-viz-host", "127.0.0.1"]
    assert tcli.main(base) == 0
    assert started == []
    assert tcli.main(base + ["--live-viz", "--max-frames", "2"]) == 0
    (viewer,) = started
    assert viewer.host == "127.0.0.1" and viewer.port > 0  # port 0 resolved by the server
    assert viewer.frames == [(1, True)] and viewer._server is None  # stopped
    assert [p["name"] for p in viewer._state["panels"]] == ["phi_global", "phi_n(psi)"]
    assert viewer._state["color"]


def _mesh(cls, n_tri, colors):
    rng = np.random.default_rng(n_tri)
    v = (rng.standard_normal((3 * n_tri, 3)) * 0.3).astype(np.float32)
    c = rng.integers(0, 256, (3 * n_tri, 3)).astype(np.uint8) if colors else None
    return cls(vertices=v, normals=np.zeros_like(v), colors=c)


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
@pytest.mark.parametrize("colors", [False, True], ids=["plain", "colors"])
def test_mesh_writer_bytes_equal_jax(tmp_path, monkeypatch, binary, colors):
    monkeypatch.setattr(jnative, "available", lambda: False)
    want, got = tmp_path / "jax.vtk", tmp_path / "port.vtk"
    jio.save_mesh_vtk(_mesh(JMesh, 7, colors), str(want), binary=binary)
    tio.save_mesh_vtk(_mesh(TMesh, 7, colors), str(got), binary=binary)
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes().splitlines()[1] == b"sobfu_tpu mesh"


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
@pytest.mark.parametrize("colors", [False, True], ids=["plain", "colors"])
def test_mesh_reader_reads_jax_files(tmp_path, monkeypatch, binary, colors):
    monkeypatch.setattr(jnative, "available", lambda: False)
    mesh = _mesh(JMesh, 9, colors)
    path = str(tmp_path / "jax.vtk")
    jio.save_mesh_vtk(mesh, path, binary=binary)
    got = tio.load_mesh_vtk(path)
    if binary:
        np.testing.assert_array_equal(got.vertices, mesh.vertices)
    else:
        np.testing.assert_array_equal(got.vertices, jio.load_mesh_vtk(path).vertices)
    if colors:
        np.testing.assert_array_equal(got.colors, mesh.colors)
    else:
        assert got.colors is None


def test_mesh_reader_reads_jax_native_writer(tmp_path):
    if not jnative.available():
        pytest.skip("the JAX package's native runtime is not built")
    v = _mesh(JMesh, 5, False).vertices
    path = str(tmp_path / "native.vtk")
    jnative.write_mesh_vtk(path, v)
    np.testing.assert_array_equal(tio.load_mesh_vtk(path).vertices,
                                  jio.load_mesh_vtk(path).vertices)


@pytest.mark.parametrize("colors", [False, True], ids=["plain", "colors"])
def test_jax_reader_reads_port_meshes(tmp_path, colors):
    mesh = _mesh(TMesh, 9, colors)
    path = str(tmp_path / "port.vtk")
    tio.save_mesh_vtk(mesh, path)
    np.testing.assert_array_equal(jio.load_mesh_vtk(path).vertices,
                                  tio.load_mesh_vtk(path).vertices)
    np.testing.assert_allclose(tio.load_mesh_vtk(path).vertices, mesh.vertices, atol=1e-5)


def test_field_readers_roundtrip_both_packages(tmp_path):
    disp = np.random.default_rng(5).standard_normal((3, 5, 6, 7)).astype(np.float32)
    a, b = str(tmp_path / "jax.vti"), str(tmp_path / "port.vti")
    jio.save_field_vti(disp, a)
    tio.save_field_vti(disp, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        for reader in (tio.load_field_vti, jio.load_field_vti):
            got = reader(path)
            assert got.dtype == np.float32 and got.shape == disp.shape
            np.testing.assert_array_equal(got, disp)


def test_load_color_matches_jax(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(6).integers(0, 256, (12, 10, 3), dtype=np.uint8)
    path = str(tmp_path / "c.png")
    Image.fromarray(rgb).save(path)
    got = tio.load_color(path)
    assert got.dtype == np.uint8 and got.shape == (12, 10, 3)
    np.testing.assert_array_equal(got, jio.load_color(path))
    np.testing.assert_array_equal(got, rgb)
