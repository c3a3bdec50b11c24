"""The port as installed: pyproject.toml names every package, its data and
its console script; the marching-cubes tables are the port's own copy; and
core's device surface answers as sobfu_tpu.core does on the CPU."""

import fnmatch
import importlib
import os
import tomllib

import jax
import numpy as np
import pytest
import torch

from sobfu_tpu import core as jcore
from sobfu_tpu_torch import core, mc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "sobfu_tpu_torch")


@pytest.fixture(scope="module")
def pyproject():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_every_port_package_is_listed(pyproject):
    listed = set(pyproject["tool"]["setuptools"]["packages"])
    found = {
        os.path.relpath(d, ROOT).replace(os.sep, ".")
        for d, _, files in os.walk(PORT)
        if "__init__.py" in files
    }
    assert "sobfu_tpu_torch.models" in found
    assert found <= listed, sorted(found - listed)


def test_package_data_covers_the_sources_and_tables(pyproject):
    patterns = pyproject["tool"]["setuptools"]["package-data"]["sobfu_tpu_torch"]
    data = [os.path.join("csrc", f) for f in sorted(os.listdir(os.path.join(PORT, "csrc")))]
    data.append("mc_tables.npz")
    for rel in data:
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel


def test_console_scripts_resolve(pyproject):
    scripts = pyproject["project"]["scripts"]
    assert scripts["sobfu-tpu-torch"] == "sobfu_tpu_torch.cli:main"
    for target in scripts.values():
        module, attr = target.split(":")
        assert callable(getattr(importlib.import_module(module), attr))


def test_mc_tables_are_the_ports_own_copy():
    assert os.path.dirname(mc._TABLE_PATH) == PORT
    want = np.load(os.path.join(ROOT, "sobfu_tpu", "mc_tables.npz"))
    got = np.load(mc._TABLE_PATH)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    tri, nv = mc.load_tables()
    np.testing.assert_array_equal(tri, want["tri_table"])
    np.testing.assert_array_equal(nv, want["num_verts_table"])


@pytest.mark.parametrize("platform", ["tpu", "gpu", "cuda", "rocm"])
def test_a_missing_platform_is_as_in_jax(platform):
    """No card here: a platform the machine lacks raises RuntimeError from
    get_devices and counts 0, in both packages."""
    if torch.cuda.is_available() and platform in ("gpu", "cuda"):
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        jcore.get_devices(platform)
    with pytest.raises(RuntimeError):
        core.get_devices(platform)
    assert core.get_device_count(platform) == jcore.get_device_count(platform) == 0


def test_cpu_devices_and_info_as_in_jax(capsys):
    got = core.get_devices("cpu")
    assert got == [torch.device("cpu")] and core.get_device_count("cpu") == 1
    assert {d.platform for d in jcore.get_devices("cpu")} == {"cpu"}
    jcore.print_device_info(jax.devices("cpu")[0])
    want = capsys.readouterr().out
    core.print_device_info(got[0])
    assert capsys.readouterr().out == want == "[0] cpu (cpu)\n"
    core.print_device_info("cpu")
    assert capsys.readouterr().out == want


def test_no_argument_is_the_card():
    """The port's default platform is the card: no argument gives the CUDA
    devices, as the port's entry points default to the card; without one
    get_devices raises and the count is 0 (its callers' no-card test)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert core.get_device_count() == core.get_device_count("gpu") == n
    if n:
        assert core.get_devices() == [torch.device("cuda", i) for i in range(n)]
    else:
        with pytest.raises(RuntimeError):
            core.get_devices()
        core.print_device_info()  # prints nothing, raises nothing
