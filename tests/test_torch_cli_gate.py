"""The port's CLI against the JAX package's CLI on one generated scene, and
the port's CLI gate (tools/validate_torch_cli_scene.py) on its artifacts.

tools/make_synthetic_scene.py writes the articulated scene (noisy depth,
occluder masks, the preset's compositive keys and NEW_SURFACE_GATE) at
32^3, 3 frames of 80x60; ``python -m sobfu_tpu_torch ... --enable-log
--device cpu`` and ``python -m sobfu_tpu ... --enable-log`` each
reconstruct a copy. At 32^3 both run the unfused compositive branch.

  - each package's logged meshes and fields read with the other package's
    loaders give the arrays its own loaders give;
  - the two CLIs' meshes have the same triangle count and vertices within
    1e-5 m, their fields agree within 3e-5 voxels (the compositive
    pipeline parity of tests/test_torch_compositive.py after three
    frames);
  - the port's gate passes on the port's artifacts (2.2 / 1.5 voxel
    budgets) and computes the same RMSE rows as tools/validate_cli_scene.py
    on the same files.

Most of the fixture's time is the JAX run's first compiles on the CPU; the
tests after it take well under a second each.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from sobfu_tpu import cli as jcli
from sobfu_tpu import io as jio
from sobfu_tpu_torch import cli as tcli
from sobfu_tpu_torch import io as tio
from tests.test_torch_pipeline import ROOT, make_synthetic_scene

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

FRAMES = (1, 2)  # the logged frames (frame 0 only integrates)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("gate")
    port, jax_ = str(root / "port"), str(root / "jax")
    make_synthetic_scene.main([port, "--frames", "3", "--dim", "32", "--preset", "articulated",
                               "--width", "80", "--height", "60"])
    shutil.copytree(port, jax_)
    assert tcli.main([port, os.path.join(port, "params.ini"), "--enable-log",
                      "--device", "cpu"]) == 0
    assert jcli.main([jax_, os.path.join(jax_, "params.ini"), "--enable-log",
                      "--no-native-loader"]) == 0
    return {"port": port, "jax": jax_}


def _artifacts(scene, i):
    return (os.path.join(scene, "meshes", f"mesh_{i:04d}.vtk"),
            os.path.join(scene, "fields", f"psi_{i:04d}.vti"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_cli_artifacts_read_by_the_other_loaders(scenes, writer):
    for i in FRAMES:
        mesh, field = _artifacts(scenes[writer], i)
        np.testing.assert_array_equal(tio.load_mesh_vtk(mesh).vertices,
                                      jio.load_mesh_vtk(mesh).vertices)
        np.testing.assert_array_equal(tio.load_field_vti(field), jio.load_field_vti(field))
        assert tio.load_field_vti(field).shape == (3, 32, 32, 32)


def test_port_and_jax_cli_artifacts_agree(scenes):
    for i in FRAMES:
        (pm, pf), (jm, jf) = _artifacts(scenes["port"], i), _artifacts(scenes["jax"], i)
        a, b = tio.load_mesh_vtk(pm), tio.load_mesh_vtk(jm)
        assert a.n_triangles == b.n_triangles > 50
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tio.load_field_vti(pf), tio.load_field_vti(jf), atol=3e-5,
                                   rtol=0)


def test_port_gate_passes_on_port_artifacts(scenes):
    res = _tool("validate_torch_cli_scene").validate(scenes["port"], 2.2, 1.5)
    assert res["ok"] and res["frames"] == len(FRAMES)
    want = _tool("validate_cli_scene").validate(scenes["port"], 2.2, 1.5)
    assert res["per_frame"] == want["per_frame"]
