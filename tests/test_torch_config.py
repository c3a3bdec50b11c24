"""Config parity and the port's import / device guards."""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sobfu_tpu import config as jc
from sobfu_tpu_torch import config as tc

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIS = sorted(glob.glob(os.path.join(ROOT, "params", "*.ini")))


def test_seven_shipped_inis():
    assert len(INIS) == 7


@pytest.mark.parametrize("ini", INIS, ids=os.path.basename)
def test_load_params_matches_jax(ini):
    want = jc.load_params(ini, verbosity=1)
    got = tc.load_params(ini, verbosity=1)
    for f in dataclasses.fields(jc.Params):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype
        else:
            assert a == b and type(a).__name__ == type(b).__name__, f.name
    assert [f.name for f in dataclasses.fields(tc.Params)] == [
        f.name for f in dataclasses.fields(jc.Params)
    ]


def test_tpu_extension_keys_parse_the_same(tmp_path):
    ini = tmp_path / "p.ini"
    ini.write_text(
        "VOL_DIMS_X=32\nWARP_WINDOW=2\nUSE_PALLAS=1\nSOLVER_MODE=additive\n"
        "MOMENTUM=0.9\nZ_CHUNKS=4\nCONV_MXU=true\nWARP_PALLAS=yes\nINVERSE_ITERS=5\n"
        "INVERSE_WARM=0\nPYRAMID_LEVELS=1\nFUSED_PALLAS=0\nINCREMENTAL_INV=1\n"
        "FINE_WINDOW=1\nSTALL_WINDOW=16\nSTALL_REL=0.01\nINNER_STEPS=0\n"
        "NEW_SURFACE_GATE=1.5\nINV_MULTIGRID=0\n"
    )
    a, b = tc.load_params(str(ini)), jc.load_params(str(ini))
    for f in dataclasses.fields(jc.Params):
        if f.name != "volume_pose":
            assert getattr(a, f.name) == getattr(b, f.name), f.name


def test_port_imports_no_jax():
    """The port never imports jax or sobfu_tpu (whose __init__ pulls in jax),
    nor do the port's CLI gate tool, the rigid scene renderer, its fidelity
    harness, mesh comparison and scene generator, its kernel bench and
    warp_field3 probe, its headline bench (bench_torch.py) and its multiscene
    and multigrid-inverse tools, and chip_smoke.py."""
    code = (
        "import sys, importlib.util, sobfu_tpu_torch, sobfu_tpu_torch.cli, "
        "sobfu_tpu_torch.ops.kernels, sobfu_tpu_torch.mc, sobfu_tpu_torch.io, "
        "sobfu_tpu_torch.core, sobfu_tpu_torch.pyramid, sobfu_tpu_torch.solver, "
        "sobfu_tpu_torch.pipeline, sobfu_tpu_torch.ops._build, sobfu_tpu_torch.parallel, "
        "sobfu_tpu_torch.parallel.zshard, sobfu_tpu_torch.tsdf, sobfu_tpu_torch.fields, "
        "sobfu_tpu_torch.utils.checkpoint, sobfu_tpu_torch.viz, sobfu_tpu_torch.viewer, "
        "sobfu_tpu_torch.native, sobfu_tpu_torch.icp, sobfu_tpu_torch.raycast, "
        "sobfu_tpu_torch.kinfu, sobfu_tpu_torch.models, sobfu_tpu_torch.reductor, "
        "sobfu_tpu_torch.scalar_fields, sobfu_tpu_torch.ops.imgproc\n"
        "for name, path in (('gate', 'tools/validate_torch_cli_scene.py'), "
        "('scene', 'tools/render_rigid_scene.py'), ('smoke', 'chip_smoke.py'), "
        "('fidelity', 'tools/fidelity_torch.py'), ('meshes', 'tools/compare_meshes_torch.py'), "
        "('generator', 'tools/make_synthetic_scene_torch.py'), "
        "('bench', 'tools/bench_torch_kernels.py'), ('probe', 'tools/probe_warp_field3.py'), "
        "('headline', 'bench_torch.py'), ('stream', 'tools/bench_multiscene_stream_torch.py'), "
        "('inverse', 'tools/check_inverse_multigrid_torch.py')):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'sobfu_tpu' or m.startswith('sobfu_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_cuda_device_without_card_raises():
    from sobfu_tpu_torch import core

    if torch.cuda.is_available():
        assert core.resolve_device("cuda").type == "cuda"
        return
    assert core.get_device_count() == 0
    with pytest.raises(RuntimeError, match="is_available"):
        core.resolve_device("cuda")
    from sobfu_tpu_torch.pipeline import SobFusion

    with pytest.raises(RuntimeError):
        SobFusion(tc.Params())  # the default device is cuda


def test_volume_and_field_default_to_the_card():
    """TsdfVolume and DeformationField built without a device run on the
    card, as SobFusion does: with no card they raise resolve_device's error
    instead of moving to the CPU. A field given its data keeps the data's
    device."""
    from sobfu_tpu_torch.fields import DeformationField, identity_field
    from sobfu_tpu_torch.tsdf import TsdfVolume

    p = tc.Params()
    p.volume_dims = (20, 16, 12)
    if torch.cuda.is_available():
        assert TsdfVolume(p).tsdf.device.type == "cuda"
        assert DeformationField(p.volume_dims).data.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        TsdfVolume(p)
    with pytest.raises(RuntimeError, match="is_available"):
        DeformationField(p.volume_dims)
    data = identity_field((12, 16, 20))
    assert DeformationField(p.volume_dims, data, device="cpu").data is data
    assert DeformationField(p.volume_dims, data).data is data


@pytest.mark.parametrize("flag", ["--enable-viz", "--enable-viz-detailed", "--live-viz",
                                  "--color-mesh", "--checkpoint=x", "--resume=x"])
def test_cli_unported_flags_exit_with_error(flag, capsys):
    """The six flags that once exited "not ported yet" are ported: each is
    parsed and main goes on to read the ini and then the scene, which here
    does not exist."""
    from sobfu_tpu_torch import cli

    with pytest.raises(FileNotFoundError, match="should contain 'color' and 'depth'"):
        cli.main(["no_scene", INIS[0], flag])
    assert "not ported" not in capsys.readouterr().err


def test_check_accelerator_and_profile_trace(tmp_path):
    """core.check_accelerator is torch.cuda.is_available(); profile_trace
    writes a Chrome trace of the enclosed code into its directory."""
    from sobfu_tpu_torch import core

    assert core.check_accelerator() is torch.cuda.is_available()
    out = tmp_path / "trace"
    with core.profile_trace(str(out)) as d:
        assert d == str(out)
        torch.ones(64).cumsum(0)
    text = (out / "trace.json").read_text()
    assert "traceEvents" in text and "cumsum" in text
