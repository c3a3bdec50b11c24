"""The port's viz (sobfu_tpu_torch.viz) and live viewer
(sobfu_tpu_torch.viewer) against the JAX package's, on the CPU.

  - screenshots of a port SobFusion at 32^3, four panels, with and
    without the colour panel;
  - ``sample_vertex_colors`` equal to ``sobfu_tpu.viz``'s, byte for byte,
    on the same mesh, image and pose (both are numpy);
  - a coloured mesh round trip through the port's ``load_mesh_vtk``, ASCII
    and binary: colours exactly (ASCII stores c / 255 at 4 decimals, which
    rounds back to c), vertices within 1e-5 (ASCII's %.6g);
  - the viewer serving its page (titled for the port) and state, and
    decimating a large mesh.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from sobfu_tpu import config as jc
from sobfu_tpu import viz as jviz
from sobfu_tpu.mc import Mesh as JMesh
from sobfu_tpu_torch import config as tc
from sobfu_tpu_torch import io as tio
from sobfu_tpu_torch import pipeline as tp
from sobfu_tpu_torch import viz
from sobfu_tpu_torch.mc import Mesh
from sobfu_tpu_torch.viewer import LiveViewer
from tests.test_torch_pipeline import _frames, _params

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fusion():
    f = tp.SobFusion(_params(tc, 2), device="cpu")
    f.need_inv_warps = False
    for d in _frames()[:2]:
        f(d)
    return f


def test_save_screenshot(tmp_path, fusion):
    out = str(tmp_path / "shot.png")
    viz.save_screenshot(fusion, out, detailed=True)
    assert os.path.getsize(out) > 1000


def test_screenshot_with_color_panel(tmp_path, fusion):
    color = np.random.default_rng(0).integers(0, 255, (48, 64, 3), dtype=np.uint8)
    plain, with_color = str(tmp_path / "plain.png"), str(tmp_path / "color.png")
    viz.save_screenshot(fusion, plain)
    viz.save_screenshot(fusion, with_color, color=color)
    assert os.path.getsize(with_color) > os.path.getsize(plain)


def test_sample_vertex_colors_matches_jax(fusion):
    mesh = fusion.get_phi_global_mesh()
    assert mesh.n_triangles > 50
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.004, -0.003, 0.01)
    intr = (60.0, 60.0, 31.5, 23.5)
    got = viz.sample_vertex_colors(mesh, img, pose, tc.Intr(*intr))
    want = jviz.sample_vertex_colors(JMesh(mesh.vertices, mesh.normals), img, pose,
                                     jc.Intr(*intr))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != 128).any()  # some vertices project into the image


def test_sample_vertex_colors_projection():
    """A vertex straight ahead of the camera samples the image centre; one
    behind it falls back to grey."""
    img = np.zeros((40, 60, 3), np.uint8)
    img[20, 30] = (200, 100, 50)
    mesh = Mesh(vertices=np.asarray([[0, 0, -0.5], [0, 0, 0.5]], np.float32),
                normals=np.zeros((2, 3), np.float32))
    c = viz.sample_vertex_colors(mesh, img, np.eye(4, dtype=np.float32),
                                 tc.Intr(50.0, 50.0, 30.0, 20.0))
    np.testing.assert_array_equal(c[0], (200, 100, 50))
    np.testing.assert_array_equal(c[1], (128, 128, 128))


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_colored_mesh_vtk_roundtrip(tmp_path, fusion, binary):
    mesh = fusion.get_phi_global_mesh()
    img = np.random.default_rng(4).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    mesh.colors = viz.sample_vertex_colors(mesh, img, fusion.poses[-1], _params(tc, 2).intr)
    path = str(tmp_path / "m.vtk")
    tio.save_mesh_vtk(mesh, path, binary=binary)
    back = tio.load_mesh_vtk(path)
    np.testing.assert_array_equal(back.colors, mesh.colors)
    if binary:
        np.testing.assert_array_equal(back.vertices, mesh.vertices)
    else:
        np.testing.assert_allclose(back.vertices, mesh.vertices, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(back.normals, np.zeros_like(mesh.vertices))


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_viewer_serves_page_and_state():
    viewer = LiveViewer(port=0).start()
    try:
        page = _get(f"http://127.0.0.1:{viewer.port}/").decode()
        assert "<title>sobfu_tpu_torch live</title>" in page and "state.json" in page
        state = json.loads(_get(f"http://127.0.0.1:{viewer.port}/state.json"))
        assert state["seq"] == 0 and state["panels"] == []
        v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [0, 1, 1]],
                       np.float32)
        c = np.full((6, 3), 200, np.uint8)
        viewer.update_meshes([("phi_global", Mesh(v, np.zeros_like(v), c))],
                             color=np.zeros((8, 8, 3), np.uint8), fps=1.5)
        state = json.loads(_get(f"http://127.0.0.1:{viewer.port}/state.json"))
        assert state["seq"] == 1 and state["fps"] == 1.5 and state["color"]
        panel = state["panels"][0]
        assert panel["name"] == "phi_global" and len(panel["v"]) == 18
        assert panel["c"] == [[200, 200, 200]] * 2
        assert _get_status(f"http://127.0.0.1:{viewer.port}/nothing") == 404
    finally:
        viewer.stop()


def _get_status(url):
    try:
        urllib.request.urlopen(url, timeout=10)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_viewer_decimates_large_meshes():
    viewer = LiveViewer(port=0, max_tris=100).start()
    try:
        v = np.random.default_rng(0).standard_normal((9000, 3)).astype(np.float32)
        viewer.update_meshes([("m", Mesh(vertices=v, normals=v))])
        state = json.loads(_get(f"http://127.0.0.1:{viewer.port}/state.json"))
        assert len(state["panels"][0]["v"]) == 100 * 9
        assert max(abs(x) for x in state["panels"][0]["v"]) <= 1.0 + 1e-6
    finally:
        viewer.stop()


def test_viewer_update_pulls_the_pipeline_panels(fusion):
    viewer = LiveViewer(port=0)  # update needs no server
    viewer.update(fusion, detailed=True, frame=7)
    names = [p["name"] for p in viewer._state["panels"]]
    assert names == ["phi_global", "phi_n(psi)", "phi_n", "phi_global(psi_inv)"]
    assert viewer._state["frame"] == 7 and all(p["v"] for p in viewer._state["panels"])
