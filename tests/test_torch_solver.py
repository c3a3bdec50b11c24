"""The port's solver against the frozen goldens and against sobfu_tpu.solver.

The golden fixture of tests/test_golden.py (16^3 spheres, 32 iterations)
is re-made with the port's own init_sphere and solved by the port's
estimate_psi on the CPU (the kernels' plain versions).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import solver as js
from sobfu_tpu import fields as jf
from sobfu_tpu.tsdf import init_sphere as j_init_sphere
from sobfu_tpu_torch import fields as tf
from sobfu_tpu_torch import solver as ts
from sobfu_tpu_torch.config import Params
from sobfu_tpu_torch.tsdf import init_sphere

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
DIMS = (16, 16, 16)
VS = 0.25 / 16


def _fixture(shift=0.118):
    tg, wg = init_sphere(DIMS, (VS,) * 3, (0.125, 0.125, 0.125), 0.04, 8 * VS, 3 * VS)
    tn, wn = init_sphere(DIMS, (VS,) * 3, (shift, 0.125, 0.125), 0.04, 8 * VS, 3 * VS)
    taps = ts.sobolev_filter_1d(7, 0.1)
    return (tf.identity_field(DIMS), tg, wg, tn, wn, taps, 0.1, 0.3, 32, -1.0)


def _jax_fixture(shift=0.118):
    tg, wg = j_init_sphere(DIMS, (VS,) * 3, (0.125, 0.125, 0.125), 0.04, 8 * VS, 3 * VS)
    tn, wn = j_init_sphere(DIMS, (VS,) * 3, (shift, 0.125, 0.125), 0.04, 8 * VS, 3 * VS)
    taps = jnp.asarray(js.sobolev_filter_1d(7, 0.1))
    return (jf.identity_field(DIMS), tg, wg, tn, wn, taps, jnp.float32(0.1),
            jnp.float32(0.3), jnp.int32(32), jnp.float32(-1.0))


@pytest.mark.parametrize("name,K", [("solver_16.npz", None), ("solver_16_window.npz", 2)])
def test_estimate_psi_matches_golden(name, K):
    """atol 1e-5, the golden gate of tests/test_golden.py."""
    res = ts.estimate_psi(*_fixture(), inverse_iters=8, warp_window=K)
    g = np.load(os.path.join(GOLDEN_DIR, name))
    np.testing.assert_allclose(res.psi.numpy(), g["psi"], atol=1e-5)
    np.testing.assert_allclose(res.tsdf_n_psi.numpy(), g["tnp"], atol=1e-5)
    np.testing.assert_allclose(res.psi_inv.numpy(), g["psi_inv"], atol=1e-5)
    np.testing.assert_allclose(res.max_norm, float(g["max_norm"]), rtol=1e-4)
    assert res.iters == 32


def test_filter_taps_match_jax():
    for s, lam in [(3, 0.1), (7, 0.1), (7, 0.2), (11, 0.1), (5, 0.3)]:
        np.testing.assert_array_equal(ts.sobolev_filter_1d(s, lam), js.sobolev_filter_1d(s, lam))


@pytest.mark.parametrize("K", [None, 2])
def test_momentum_energy_and_tails_match_jax(K):
    """Heavy-ball momentum with the energy history and every tail output.
    Energies are sums over the grid in another order: rtol 1e-4."""
    kw = dict(inverse_iters=3, warp_window=K, momentum=0.9, record_energy=True,
              energy_cap=32)
    res = ts.estimate_psi(*_fixture(), **kw)
    want = js.estimate_psi(*_jax_fixture(), **kw)
    for field in ("psi", "psi_inv", "tsdf_n_psi", "weight_n_psi", "tsdf_global_psi_inv",
                  "weight_global_psi_inv"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(want, field)), atol=1e-5,
            err_msg=field,
        )
    np.testing.assert_allclose(res.energy.numpy(), np.asarray(want.energy), rtol=1e-4,
                               atol=1e-6)
    assert res.iters == int(want.iters) == 32


@pytest.mark.parametrize("thresh,stall", [(5e-4, 0), (-1.0, 4)])
def test_stopping_semantics_match_jax(thresh, stall):
    """MAX_UPDATE_NORM (67 iterations here) and the data-energy stall stop
    (44) end the solve on the same iteration as JAX's while_loop: the port
    tests the stop after every iteration."""
    args, jargs = list(_fixture()), list(_jax_fixture())
    args[8], jargs[8] = 100, jnp.int32(100)
    args[9], jargs[9] = thresh, jnp.float32(thresh)
    kw = dict(inverse_iters=2, warp_window=2, stall_window=stall, stall_rel=0.01)
    res = ts.estimate_psi(*args, **kw)
    want = js.estimate_psi(*jargs, **kw)
    assert 8 < res.iters == int(want.iters) < 100
    np.testing.assert_allclose(res.psi.numpy(), np.asarray(want.psi), atol=1e-5)


def test_skip_flags_pass_through():
    p = _fixture()
    res = ts.estimate_psi(*p, inverse_iters=2, warp_window=2, skip_inv_warps=True,
                          skip_weight_warp=True)
    assert res.tsdf_global_psi_inv is p[1] and res.weight_global_psi_inv is p[2]
    assert res.weight_n_psi is p[4]


def _params(**kw):
    p = Params()
    p.volume_dims = (16, 16, 16)
    p.max_iter = 4
    p.max_update_norm = -1.0
    p.verbosity = 1
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def test_solver_class_verbose_prints(capsys):
    from sobfu_tpu_torch.fields import DeformationField
    from sobfu_tpu_torch.tsdf import TsdfVolume

    p = _params(warp_window=2)
    s = ts.Solver(p)
    assert s.inverse_warm and s.inverse_iters == 3
    vols = [TsdfVolume(p) for _ in range(4)]
    vols[0].init_sphere((0.5, 0.5, 0.5), 0.3)
    vols[2].init_sphere((0.48, 0.5, 0.5), 0.3)
    psi, psi_inv = DeformationField(p.volume_dims), DeformationField(p.volume_dims)
    res = s.estimate_psi(vols[0], vols[1], vols[2], vols[3], psi, psi_inv)
    out = capsys.readouterr().out
    assert "iter. no. 1: data energy + w_reg * reg energy" in out
    assert "SOLVER REACHED MAX. NO. OF ITERATIONS WITHOUT CONVERGING" in out
    assert psi.data is res.psi and vols[3].tsdf is res.tsdf_n_psi


@pytest.mark.parametrize("key,value,match", [
    ("solver_mode", "compositive", "SOLVER_MODE=compositive"),
    ("pyramid_levels", 2, "PYRAMID_LEVELS"),
    ("inner_steps", 16, "INNER_STEPS"),
    ("inv_multigrid", True, "INV_MULTIGRID"),
    ("inv_coarse", True, "INV_COARSE"),
])
def test_unported_keys_raise(key, value, match):
    with pytest.raises(NotImplementedError, match=match):
        ts.Solver(_params(**{key: value}))


def test_tpu_dispatch_keys_have_no_effect():
    """USE_PALLAS / WARP_PALLAS / Z_CHUNKS / CONV_MXU / FOLD_XMATS pick TPU
    layouts; the port's solve is the same with and without them."""
    plain = ts.Solver(_params(warp_window=2, verbosity=0))
    tpu = ts.Solver(_params(warp_window=2, verbosity=0, use_pallas=True, warp_pallas=True,
                            z_chunks=8, conv_mxu=True, fold_xmats=True))
    assert plain.solve_kwargs() == tpu.solve_kwargs()
