"""The port's checkpoint (sobfu_tpu_torch.utils.checkpoint) against the JAX
package's, on the CPU at 32^3.

  - a round trip restores every key, dtype, shape and bit, and the resumed
    pipeline keeps processing;
  - 3 frames + save + load + 3 frames equal 6 frames straight, bit for bit,
    in the no-log loop (both stale flags set), with the per-frame inverse
    warps, and in pyramid mode with the half-resolution psi_inv carry;
  - a half-res carry resumed with the inverse warps on (the viz flags)
    continues as an uninterrupted run that switches them on at that frame:
    the multigrid inverse takes the half-res warm start as it is, as
    ``sobfu_tpu.solver.estimate_inverse_multigrid`` does (its parity is
    tests/test_torch_pyramid.py's ``half`` case);
  - a checkpoint written by ``sobfu_tpu`` loads into the port and the
    reverse, with the JAX keys, dtypes and shapes, and the next frame of
    either package agrees with the other's within the pipeline parity
    tolerance of tests/test_torch_pipeline.py: volumes and fields at atol
    1e-5, weights exactly;
  - the orbax-named pair is the .npz pair;
  - the CLI's --checkpoint / --resume: 2 + resume + 2 frames equal 4
    straight, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import config as jc
from sobfu_tpu import pipeline as jp
from sobfu_tpu.utils import checkpoint as jckpt
from sobfu_tpu_torch import config as tc
from sobfu_tpu_torch import pipeline as tp
from sobfu_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_pipeline import DIM, PYRAMID_KEYS, _params, make_synthetic_scene

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

H, W = 48, 64


def _frames(n=6):
    intr = (60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5)
    return [
        make_synthetic_scene.render_prims_depth(H, W, *intr, [((0.005 * i, 0.0, 0.45), 0.08)])
        for i in range(n)
    ]


# the pyramid's no-log loop with the half-res inverse carry (Solver.inv_coarse,
# an attribute with no .ini key; INV_MULTIGRID auto: on with the fused path),
# at MAX_ITER 16
HALF_RES = {**PYRAMID_KEYS, "fused_pallas": True, "inv_coarse": True, "inv_multigrid": None,
            "max_iter": 16}


def _port(need_inv_warps=False, **extra):
    f = tp.SobFusion(_params(tc, 2, **extra), device="cpu")
    f.need_inv_warps = need_inv_warps
    return f


def _assert_same_state(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_checkpoint_roundtrip(tmp_path):
    frames = _frames(4)
    f = _port()
    for d in frames[:3]:
        f(d)
    path = str(tmp_path / "state.npz")
    tckpt.save_checkpoint(path, f)
    fresh = _port()
    tckpt.load_checkpoint(path, fresh)
    _assert_same_state(tckpt.state_dict(fresh), tckpt.state_dict(f))
    assert fresh.frame_counter == 3 and fresh.psi.dims == (DIM,) * 3
    assert fresh.phi_global.tsdf.device.type == "cpu"
    assert fresh._inv_warps_stale and fresh._n_psi_weight_stale
    assert fresh(frames[3]) and fresh.frame_counter == 4


# (need_inv_warps, extra params): the no-log loop, the per-frame inverse
# warps, and the pyramid's no-log loop with the half-res carry
RESUME_CASES = [
    (False, {}),
    (True, {}),
    (False, HALF_RES),
]


@pytest.mark.parametrize("need_inv,extra", RESUME_CASES, ids=["nolog", "inv-warps", "half-res"])
def test_resume_equals_straight(tmp_path, need_inv, extra):
    frames = _frames()
    straight, first, resumed = (_port(need_inv, **extra) for _ in range(3))
    for d in frames:
        straight(d)
    for d in frames[:3]:
        first(d)
    path = str(tmp_path / "state.npz")
    tckpt.save_checkpoint(path, first)
    tckpt.load_checkpoint(path, resumed)
    for d in frames[3:]:
        resumed(d)
    want = tckpt.state_dict(straight)
    _assert_same_state(tckpt.state_dict(resumed), want)
    if "inv_coarse" in extra:
        assert straight.solver.inv_coarse
        assert want["psi_inv"].shape == (3,) + (DIM // 2,) * 3
        assert resumed.psi_inv.dims == (DIM // 2,) * 3  # dims from the stored array
    else:
        assert want["psi_inv"].shape == (3,) + (DIM,) * 3


def test_half_res_carry_resumed_with_inverse_warps(tmp_path):
    """A half-res checkpoint resumed where the inverse warps are on."""
    frames = _frames(5)
    straight, first, resumed = (_port(False, **HALF_RES) for _ in range(3))
    for f in (straight, first):
        for d in frames[:3]:
            f(d)
    path = str(tmp_path / "state.npz")
    tckpt.save_checkpoint(path, first)
    tckpt.load_checkpoint(path, resumed)
    assert tuple(resumed.psi_inv.data.shape) == (3,) + (DIM // 2,) * 3
    for f in (straight, resumed):
        f.need_inv_warps = True
        for d in frames[3:]:
            f(d)
    assert tuple(resumed.psi_inv.data.shape) == (3,) + (DIM,) * 3
    _assert_same_state(tckpt.state_dict(resumed), tckpt.state_dict(straight))
    resumed.get_phi_global_psi_inv_mesh()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Both packages over frames 0-2 in the no-log window loop, each
    checkpointed, then frame 3 continued by each."""
    tmp = tmp_path_factory.mktemp("ckpt")
    frames = _frames(4)
    fj = jp.SobFusion(_params(jc, 2))
    fj.need_inv_warps = False
    ft = _port()
    for d in frames[:3]:
        fj(jnp.asarray(d))
        ft(d)
    paths = {"jax": str(tmp / "jax.npz"), "port": str(tmp / "port.npz")}
    jckpt.save_checkpoint(paths["jax"], fj)
    tckpt.save_checkpoint(paths["port"], ft)
    states = {"jax": jckpt.state_dict(fj), "port": tckpt.state_dict(ft)}
    fj(jnp.asarray(frames[3]))
    ft(frames[3])
    return dict(fj=fj, ft=ft, paths=paths, states=states, frame=frames[3])


def _jax_state(fj):
    return [np.asarray(x) for x in (fj.phi_global.tsdf, fj.phi_global.weight, fj.psi.data,
                                    fj.psi_inv.data)]


def _port_state(ft):
    return [x.numpy() for x in (ft.phi_global.tsdf, ft.phi_global.weight, ft.psi.data,
                                ft.psi_inv.data)]


def _assert_close(got, want):
    """(tsdf, weight, psi, psi_inv): atol 1e-5, the weights exactly."""
    for name, g, w in zip(("tsdf", "weight", "psi", "psi_inv"), got, want):
        if name == "weight":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)


def test_state_dict_keys_dtypes_shapes_match_jax(jax_runs):
    """The same keys, dtypes and shapes; the same values within the parity
    tolerance, except phi_n_psi's weight: the port's no-log loop leaves it
    to its getter (n_psi_weight_stale), where JAX's XLA fuse on the CPU
    hands the warped weight back (its flag needs the fused Pallas path)."""
    j, t = jax_runs["states"]["jax"], jax_runs["states"]["port"]
    assert sorted(j) == sorted(t)
    for k in j:
        assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
    for k in ("frame_counter", "poses", "inv_warps_stale"):
        np.testing.assert_array_equal(t[k], j[k])
    assert bool(t["n_psi_weight_stale"]) and not bool(j["n_psi_weight_stale"])
    for k in j:
        if k == "phi_n_psi_weight":
            continue
        if k.endswith("weight"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        elif j[k].dtype == np.float32:
            np.testing.assert_allclose(t[k], j[k], atol=1e-5, err_msg=k)


def test_jax_checkpoint_loads_into_port(jax_runs):
    ft = _port()
    tckpt.load_checkpoint(jax_runs["paths"]["jax"], ft)
    assert ft.frame_counter == 3 and ft.phi_global.tsdf.dtype == torch.float32
    ft(jax_runs["frame"])
    _assert_close(_port_state(ft), _jax_state(jax_runs["fj"]))
    assert ft.last_solve.iters == int(jax_runs["fj"].last_solve.iters)


def test_port_checkpoint_loads_into_jax(jax_runs):
    fj = jp.SobFusion(_params(jc, 2))
    fj.need_inv_warps = False
    jckpt.load_checkpoint(jax_runs["paths"]["port"], fj)
    assert fj.frame_counter == 3
    fj(jnp.asarray(jax_runs["frame"]))
    _assert_close(_jax_state(fj), _port_state(jax_runs["ft"]))


def test_checkpoint_orbax_roundtrip(tmp_path):
    """The orbax-named pair writes and reads the .npz of save_checkpoint
    (orbax is a JAX library), which the JAX package's .npz reader takes."""
    f = _port()
    for d in _frames(3):
        f(d)
    path = str(tmp_path / "orbax_state.npz")
    tckpt.save_checkpoint_orbax(path, f)
    fresh = _port()
    tckpt.load_checkpoint_orbax(path, fresh)
    _assert_same_state(tckpt.state_dict(fresh), tckpt.state_dict(f))
    fj = jp.SobFusion(_params(jc, 2))
    jckpt.load_checkpoint(path, fj)
    np.testing.assert_array_equal(np.asarray(fj.psi.data), f.psi.data.numpy())


def test_cli_checkpoint_resume(tmp_path, capsys):
    """python -m sobfu_tpu_torch ... --checkpoint / --resume on a tiny scene
    from tools/make_synthetic_scene.py: 2 + resume + 2 frames equal 4."""
    from sobfu_tpu_torch import cli

    scene = tmp_path / "scene"
    make_synthetic_scene.main([str(scene), "--frames", "4", "--dim", "24", "--width", "64",
                               "--height", "48"])
    ini = scene / "params.ini"
    ini.write_text(ini.read_text() + "MAX_ITER=8\n")
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    base = [str(scene), str(ini), "--device", "cpu", "--checkpoint"]
    assert cli.main(base + [a]) == 0
    assert cli.main(base + [b, "--max-frames", "2"]) == 0
    capsys.readouterr()
    assert cli.main(base + [b, "--resume", b]) == 0
    out = capsys.readouterr().out
    assert "resumed at frame 2" in out and "processed 2 frames" in out
    with np.load(a) as x, np.load(b) as y:
        _assert_same_state(dict(x), dict(y))
