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
    vols = [TsdfVolume(p, device="cpu") for _ in range(4)]
    vols[0].init_sphere((0.5, 0.5, 0.5), 0.3)
    vols[2].init_sphere((0.48, 0.5, 0.5), 0.3)
    psi, psi_inv = (DeformationField(p.volume_dims, device="cpu"),
                    DeformationField(p.volume_dims, device="cpu"))
    res = s.estimate_psi(vols[0], vols[1], vols[2], vols[3], psi, psi_inv)
    out = capsys.readouterr().out
    assert "iter. no. 1: data energy + w_reg * reg energy" in out
    assert "SOLVER REACHED MAX. NO. OF ITERATIONS WITHOUT CONVERGING" in out
    assert psi.data is res.psi and vols[3].tsdf is res.tsdf_n_psi


def test_tpu_dispatch_keys_have_no_effect():
    """USE_PALLAS / WARP_PALLAS / Z_CHUNKS / CONV_MXU / FOLD_XMATS pick TPU
    layouts; the port's solve is the same with and without them."""
    plain = ts.Solver(_params(warp_window=2, verbosity=0))
    tpu = ts.Solver(_params(warp_window=2, verbosity=0, use_pallas=True, warp_pallas=True,
                            z_chunks=8, conv_mxu=True, fold_xmats=True))
    assert plain.solve_kwargs() == tpu.solve_kwargs()


# keys on top of _params (16^3 unless volume_dims is given); FUSED_PALLAS is
# explicit, because JAX's automatic rule holds only off the CPU
DERIVATION_CASES = {
    "pyramid-128": dict(volume_dims=(128,) * 3, warp_window=2, pyramid_levels=2,
                        fused_pallas=True, stall_window=16, max_iter=1024, inv_coarse=True),
    "pyramid-3-odd": dict(volume_dims=(90,) * 3, warp_window=2, pyramid_levels=3,
                          fused_pallas=True),
    "pyramid-unfused": dict(volume_dims=(32,) * 3, warp_window=2, pyramid_levels=2,
                            fused_pallas=False, inv_coarse=True),
    "multigrid-explicit": dict(volume_dims=(32,) * 3, warp_window=2, pyramid_levels=2,
                               fused_pallas=False, inv_multigrid=True, inv_coarse=True),
    "inner-64": dict(volume_dims=(64,) * 3, warp_window=1, fused_pallas=True, inner_steps=16,
                     stall_window=32, max_iter=1024),
    "inner-cap": dict(volume_dims=(64,) * 3, warp_window=1, fused_pallas=True, inner_steps=16,
                      max_iter=1000),
    "inner-stall": dict(volume_dims=(64,) * 3, warp_window=1, fused_pallas=True,
                        inner_steps=16, stall_window=24, max_iter=1024),
    "inner-128": dict(volume_dims=(128,) * 3, warp_window=2, fused_pallas=True,
                      inner_steps=16, max_iter=1024),
    "fused-no-window": dict(volume_dims=(64,) * 3, fused_pallas=True, pyramid_levels=2),
    "cold": dict(volume_dims=(64,) * 3, warp_window=2, inverse_warm=False, pyramid_levels=2,
                 fused_pallas=True),
    "compositive-128": dict(volume_dims=(128,) * 3, solver_mode="compositive", warp_window=2,
                            momentum=0.9, pyramid_levels=2, fused_pallas=True, stall_window=16,
                            max_iter=1024),
    "compositive-incremental-off": dict(volume_dims=(32,) * 3, solver_mode="compositive",
                                        warp_window=2, incremental_inverse=False,
                                        fused_pallas=False),
    "fine-window-128": dict(volume_dims=(128,) * 3, warp_window=2, momentum=0.95,
                            pyramid_levels=2, fine_window=1, fused_pallas=True, stall_window=16,
                            max_iter=1024, inv_coarse=True),
}


@pytest.mark.parametrize("case", sorted(DERIVATION_CASES))
def test_solver_derivations_match_jax(case):
    from sobfu_tpu import config as jc

    keys = DERIVATION_CASES[case]
    port = ts.Solver(_params(**keys))
    jp = jc.Params()
    jp.volume_dims, jp.max_iter, jp.max_update_norm, jp.verbosity = (16, 16, 16), 4, -1.0, 1
    for k, v in keys.items():
        setattr(jp, k, v)
    want = js.Solver(jp)
    assert port.fused == want.fused_pallas
    for name in ("pyramid_levels", "warp_window", "inv_multigrid", "inner_steps",
                 "inv_coarse", "inverse_warm", "inverse_iters", "stall_window", "momentum",
                 "mode", "incremental_inverse", "fine_window"):
        assert getattr(port, name) == getattr(want, name), name


@pytest.mark.parametrize("keys,fused", [
    (dict(volume_dims=(128,) * 3, warp_window=2), True),
    (dict(volume_dims=(64,) * 3, warp_window=4), True),
    (dict(volume_dims=(32,) * 3, warp_window=2), False),
    (dict(volume_dims=(128,) * 3), False),
    (dict(volume_dims=(128,) * 3, warp_window=5), False),
    (dict(volume_dims=(128,) * 3, warp_window=2, s=9), False),
])
def test_solver_fused_rule_is_the_accelerators(keys, fused):
    """WARP_WINDOW in 1..4, at most 7 taps, X >= 64: on every device."""
    s = ts.Solver(_params(**keys))
    assert s.fused is fused
    assert s.inv_multigrid is False  # no pyramid
    assert ts.Solver(_params(pyramid_levels=2, **keys)).inv_multigrid is fused


def test_chunked_stop_lands_on_first_chunk_below_threshold():
    """inner_steps=3 (kernel E's plain version): the solve stops on the
    first multiple of 3 at which the single-step norm history is at or
    below the threshold, with the same state as that many single steps."""
    args = list(_fixture())
    args[6], args[8] = 0.05, 200
    hist = ts.estimate_psi(*args, warp_window=2, momentum=0.95, inverse_iters=2,
                           record_energy=True, energy_cap=200).energy[:, 2].numpy()
    thresh = float(np.sort(hist[40:120])[5])  # a norm a few steps past iteration 40
    args[9] = thresh
    single = ts.estimate_psi(*args, warp_window=2, momentum=0.95, inverse_iters=2)
    chunked = ts.estimate_psi(*args, warp_window=2, momentum=0.95, inverse_iters=2,
                              inner_steps=3)
    want = next(m for m in range(3, 201, 3) if hist[m - 1] <= np.float32(thresh))
    assert chunked.iters == want and single.iters <= want < single.iters + 3
    args[8], args[9] = want, -1.0
    fixed = ts.estimate_psi(*args, warp_window=2, momentum=0.95, inverse_iters=2)
    assert torch.equal(chunked.psi, fixed.psi)


def test_chunked_energy_rows_and_stall_match_single_steps():
    """record_energy with chunks writes the same rows as single steps, and
    the stall stop (checked on chunk ends) ends on the same iteration."""
    args = list(_fixture())
    args[8] = 100
    kw = dict(warp_window=2, momentum=0.9, inverse_iters=2, stall_window=4, stall_rel=0.01,
              record_energy=True, energy_cap=100)
    single = ts.estimate_psi(*args, **kw)
    chunked = ts.estimate_psi(*args, inner_steps=2, **kw)
    assert 8 < chunked.iters == single.iters < 100
    np.testing.assert_allclose(chunked.energy.numpy(), single.energy.numpy(), rtol=1e-6)
    assert torch.equal(chunked.psi, single.psi)


X64_DIMS = (8, 8, 64)


def _x64_scene():
    """A smooth x-profile on the X=64 fold grid and its copy moved 1.2 voxels."""
    z, y, x = np.meshgrid(*[np.arange(d, dtype=np.float32) for d in X64_DIMS], indexing="ij")

    def profile(shift):
        return np.clip((x - 32 - shift - 0.5 * np.sin(z) - 0.3 * np.cos(y)) / 4, -1, 1)

    return profile(0.0).astype(np.float32), profile(1.2).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.0305, -1.0], ids=["norm-stop", "stall-stop"])
def test_chunked_solve_matches_jax_multi_fold(thresh):
    """inner_steps=16 against JAX's own chunked path (fused_gd_multi_fold in
    interpret mode, record_energy on): the norm stop lands on 48 and the
    stall stop on 64, with the same energy rows. The first case compiles
    the interpret-mode kernel (about 7 s on one core); the second reuses it.
    psi holds absolute coordinates up to 64, so atol 2e-5 is 3 ulp there
    (tests/test_pallas.py holds the fold path to the XLA one at 2e-5)."""
    tg, tn = _x64_scene()
    taps = ts.sobolev_filter_1d(7, 0.1)
    kw = dict(warp_window=2, momentum=0.95, inverse_iters=2, stall_window=16, stall_rel=1e-2,
              record_energy=True, energy_cap=96)
    t = torch.from_numpy
    port = ts.estimate_psi(tf.identity_field(X64_DIMS), t(tg), t(tg), t(tn), t(tn), taps, 0.05,
                           0.2, 96, thresh, inner_steps=16, **kw)
    j = jnp.asarray
    want = js.estimate_psi(jf.identity_field(X64_DIMS), j(tg), j(tg), j(tn), j(tn), j(taps),
                           jnp.float32(0.05), jnp.float32(0.2), jnp.int32(96),
                           jnp.float32(thresh), fused_db=True, db_interpret=True, inner_steps=16,
                           taps_static=tuple(float(v) for v in taps), **kw)
    assert port.iters == int(want.iters) == (48 if thresh > 0 else 64)
    for field, atol in (("psi", 2e-5), ("psi_inv", 2e-5), ("tsdf_n_psi", 1e-5),
                        ("tsdf_global_psi_inv", 1e-5), ("weight_n_psi", 0)):
        np.testing.assert_allclose(getattr(port, field).numpy(),
                                   np.asarray(getattr(want, field)), atol=atol, err_msg=field)
    np.testing.assert_allclose(port.energy.numpy(), np.asarray(want.energy), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("max_iter,thresh,want", [(96, 0.0305, 48), (40, -1.0, 48),
                                                  (24, -1.0, 32), (96, -1.0, 64)],
                         ids=["norm-stop", "cap-40", "cap-24", "stall-stop"])
def test_multi_launch_loop_matches_jax_multi_fold(max_iter, thresh, want):
    """The E loop as the solves run it (kernels.GdMultiLoop: up to 8 chunks
    of 16 per host read, here on the plain version) against JAX's chunked
    path: the norm stop inside a chunk lands on 48, caps of 40 and 24
    overshoot to 48 and 32 as JAX's while_loop does, the stall stop lands
    on 64. JAX runs
    with record_energy as the test above does (the same compiled kernel;
    the rows do not change its stops), the port without it, so several
    chunks go per read: one read covers each solve here."""
    from sobfu_tpu_torch.ops import kernels

    tg, tn = _x64_scene()
    taps = ts.sobolev_filter_1d(7, 0.1)
    kw = dict(warp_window=2, momentum=0.95, inverse_iters=2, stall_window=16, stall_rel=1e-2)
    t = torch.from_numpy
    kernels.reset_launch_counts()
    port = ts.estimate_psi(tf.identity_field(X64_DIMS), t(tg), t(tg), t(tn), t(tn), taps, 0.05,
                           0.2, max_iter, thresh, inner_steps=16, **kw)
    assert kernels.host_reads["gd_multi"] == -(-want // (16 * kernels.GD_MULTI_LAUNCHES))
    j = jnp.asarray
    want_j = js.estimate_psi(jf.identity_field(X64_DIMS), j(tg), j(tg), j(tn), j(tn), j(taps),
                             jnp.float32(0.05), jnp.float32(0.2), jnp.int32(max_iter),
                             jnp.float32(thresh), fused_db=True, db_interpret=True,
                             inner_steps=16, taps_static=tuple(float(v) for v in taps),
                             record_energy=True, energy_cap=96, **kw)
    assert port.iters == int(want_j.iters) == want
    np.testing.assert_allclose(port.psi.numpy(), np.asarray(want_j.psi), atol=2e-5)
    np.testing.assert_allclose(port.tsdf_n_psi.numpy(), np.asarray(want_j.tsdf_n_psi), atol=1e-5)
    np.testing.assert_allclose(port.max_norm, float(want_j.max_norm), rtol=1e-5)


def test_stall_message_counts_every_pyramid_level(capsys):
    """iters includes the coarse level: the stall verdict compares it with
    MAX_ITER * PYRAMID_LEVELS (sobfu_tpu/solver.py:1451-1453)."""
    from sobfu_tpu_torch.fields import DeformationField
    from sobfu_tpu_torch.tsdf import TsdfVolume

    p = _params(warp_window=2, pyramid_levels=2, max_iter=40, stall_window=4, stall_rel=0.5,
                momentum=0.95, alpha=0.05)
    s = ts.Solver(p)
    vols = [TsdfVolume(p, device="cpu") for _ in range(4)]
    vols[0].init_sphere((0.5, 0.5, 0.5), 0.3)
    vols[2].init_sphere((0.47, 0.5, 0.5), 0.3)
    psi, psi_inv = (DeformationField(p.volume_dims, device="cpu"),
                    DeformationField(p.volume_dims, device="cpu"))
    res = s.estimate_psi(vols[0], vols[1], vols[2], vols[3], psi, psi_inv)
    out = capsys.readouterr().out
    assert res.coarse_iters == 40 and p.max_iter < res.iters < 2 * p.max_iter
    assert f"SOLVER STOPPED ON DATA-ENERGY STALL AFTER {res.iters} ITERATIONS" in out


@pytest.mark.parametrize("amp,K", [(0.3, 1), (1.7, 1), (2.6, 2), (0.0, 2)])
def test_window_guard_margin_matches_jax(amp, K):
    """min over components of (disp + K, K + 1 - disp): the same f32
    subtractions of the same extremes, bit for bit."""
    rng = np.random.default_rng(int(amp * 10) + K)
    ident = np.asarray(jf.identity_field(DIMS))
    psi = (ident + rng.uniform(-amp, amp, ident.shape)).astype(np.float32)
    got = ts.window_guard_margin(torch.from_numpy(psi), K)
    want = js.window_guard_margin(jnp.asarray(psi), K)
    assert got.shape == () and float(got) == float(want)
    assert (float(got) > 0) == (amp < K)


def _jax_spied_pyramid(jargs, **kw):
    """JAX's estimate_psi_pyramid and the iterations of each level's solve."""
    level_iters, orig = [], js.estimate_psi

    def spy(*a, **k):
        out = orig(*a, **k)
        level_iters.append(int(out.iters))
        return out

    js.estimate_psi = spy  # estimate_psi_pyramid calls it through the module
    try:
        return js.estimate_psi_pyramid(*jargs, fused_db=False, **kw), level_iters
    finally:
        js.estimate_psi = orig


def test_pyramid_coarse_thresh_scale_matches_jax():
    """coarse_thresh_scale=0.25 stops the coarse level at thresh / 4 where
    the default 0.5 stops it at thresh / 2: the port's coarse and fine
    iterations equal JAX's under both, and the fields within 1e-5."""
    kw = dict(levels=2, warp_window=2, momentum=0.95, stall_window=16, stall_rel=1e-2,
              inverse_iters=3)
    args, jargs = list(_fixture(0.110)), list(_jax_fixture(0.110))
    args[6:10] = 0.05, 0.2, 200, 4e-3
    jargs[6:10] = jnp.float32(0.05), jnp.float32(0.2), jnp.int32(200), jnp.float32(4e-3)
    coarse = {}
    for scale in (0.5, 0.25):
        port = ts.estimate_psi_pyramid(*args, coarse_thresh_scale=scale, **kw)
        want, (c, f) = _jax_spied_pyramid(jargs, coarse_thresh_scale=scale, **kw)
        assert (port.coarse_iters, port.iters - port.coarse_iters) == (c, f)
        assert port.iters == int(want.iters) < 400
        np.testing.assert_allclose(port.psi.numpy(), np.asarray(want.psi), atol=1e-5)
        np.testing.assert_allclose(port.tsdf_n_psi.numpy(), np.asarray(want.tsdf_n_psi),
                                   atol=1e-5)
        coarse[scale] = c
    assert coarse[0.25] > coarse[0.5]  # the tighter coarse threshold runs longer


@pytest.mark.parametrize("window,refine", [(4, 1), (16, 2), (3, 0)])
def test_compositive_inverse_iterations_match_jax(window, refine):
    """The incremental inverse of estimate_psi_compositive with
    inv_window_iters / inv_refine_iters (JAX's solver.py:1660-1680) at 16^3:
    psi0 has drifted 1.5 voxels; psi_inv within 2e-5 of JAX's (the exact
    samples of a drifted field: an ulp of a coordinate moves the blend)."""
    rng = np.random.default_rng(5)
    ident = np.asarray(jf.identity_field(DIMS))
    disp0 = np.zeros_like(ident)
    disp0[0] = 1.5
    disp0 += rng.uniform(-0.2, 0.2, ident.shape).astype(np.float32)
    psi0, psi_inv0 = (ident + disp0).astype(np.float32), (ident - disp0).astype(np.float32)
    base, jbase = _fixture(0.125 + 1.9 * VS), _jax_fixture(0.125 + 1.9 * VS)
    kw = dict(warp_window=2, momentum=0.9, inverse_iters=4, inv_window_iters=window,
              inv_refine_iters=refine)
    T = torch.from_numpy
    port = ts.estimate_psi_compositive(T(psi0), *base[1:8], 24, -1.0, T(psi_inv0), **kw)
    want = js.estimate_psi_compositive(jnp.asarray(psi0), *jbase[1:8], jnp.int32(24),
                                       jnp.float32(-1.0), jnp.asarray(psi_inv0), **kw)
    assert port.iters == int(want.iters) == 24
    np.testing.assert_allclose(port.psi.numpy(), np.asarray(want.psi), atol=2e-5)
    np.testing.assert_allclose(port.psi_inv.numpy(), np.asarray(want.psi_inv), atol=2e-5)
    if (window, refine) != (16, 2):  # the knobs change the inverse
        default = ts.estimate_psi_compositive(T(psi0), *base[1:8], 24, -1.0, T(psi_inv0),
                                              warp_window=2, momentum=0.9, inverse_iters=4)
        assert float((default.psi_inv - port.psi_inv).abs().max()) > 1e-4


def test_compositive_coarse_max_iter_matches_jax():
    """The increment pyramid's coarse level capped at 5 iterations, as
    JAX's coarse_max_iter caps it."""
    base, jbase = _fixture(0.125 + 1.2 * VS), _jax_fixture(0.125 + 1.2 * VS)
    kw = dict(warp_window=2, momentum=0.9, inverse_iters=3, pyramid_levels=2,
              coarse_max_iter=5)
    port = ts.estimate_psi_compositive(*base[:8], 20, -1.0, **kw)
    want = js.estimate_psi_compositive(*jbase[:8], jnp.int32(20), jnp.float32(-1.0), **kw)
    assert port.coarse_iters == 5 and port.iters == int(want.iters) == 25
    np.testing.assert_allclose(port.psi.numpy(), np.asarray(want.psi), atol=2e-5)
