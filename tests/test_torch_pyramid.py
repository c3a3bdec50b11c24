"""The port's coarse-to-fine pyramid against sobfu_tpu.solver on the CPU.

Resize and pool matrices, the volume/field resamples, the multigrid
inverse (held to the same composition of JAX's plain pieces, not to
interpret-mode Pallas), the pyramid solve against its frozen golden and
against ``js.estimate_psi_pyramid(..., fused_db=False)`` with the production
momentum and stall stop, and the coarse-level dispatch to kernel E on an
X=64 grid. Inputs are made from a numpy seed or the golden fixture.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import fields as jf
from sobfu_tpu import solver as js
from sobfu_tpu.tsdf import init_sphere as j_init_sphere
from sobfu_tpu_torch import fields as tf
from sobfu_tpu_torch import pyramid as tp
from sobfu_tpu_torch import solver as ts
from sobfu_tpu_torch.ops import kernels
from sobfu_tpu_torch.tsdf import init_sphere

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
DIMS = (16, 16, 16)
VS = 0.25 / 16


def _rng_field(dims, amp, seed):
    rng = np.random.default_rng(seed)
    ident = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")[::-1])
    return (ident + rng.uniform(-amp, amp, (3,) + tuple(dims))).astype(np.float32)


@pytest.mark.parametrize("n,m", [(16, 8), (8, 16), (64, 32), (32, 64), (128, 64),
                                 (64, 128), (256, 128)])
def test_resize_matrix_matches_jax(n, m):
    """The antialiased 4-tap down-resize and the 2-tap up-resize, atol 1e-7."""
    got = tp.linear_resize_matrix(n, m)
    want = js._linear_resize_matrix(n, m)
    assert got.shape == want.shape == (m, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("n", [8, 16, 64])
def test_pool2_matrix_matches_jax(n):
    np.testing.assert_allclose(tp.pool2_matrix(n), js._pool2_matrix(n), atol=1e-7, rtol=0)


@pytest.mark.parametrize("dims", [(16, 16, 16), (8, 8, 64), (12, 16, 20)])
def test_downsample2_matches_jax(dims):
    vol = np.random.default_rng(3).standard_normal(dims).astype(np.float32)
    got = tp.downsample2(torch.from_numpy(vol))
    want = js._downsample2(jnp.asarray(vol))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dims,out,scale", [((16, 16, 16), (8, 8, 8), 0.5),
                                            ((8, 8, 8), (16, 16, 16), 2.0),
                                            ((8, 8, 64), (16, 16, 128), 2.0),
                                            ((12, 16, 20), (6, 8, 10), 0.25)])
def test_resample_disp_matches_jax(dims, out, scale):
    disp = np.random.default_rng(4).uniform(-2, 2, (3,) + dims).astype(np.float32)
    got = tp.resample_disp(torch.from_numpy(disp), out, scale)
    want = js._resample_disp(jnp.asarray(disp), out, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _jax_multigrid(psi, iters, K, init, fine_iters, return_coarse):
    """sobfu_tpu.solver.estimate_inverse_multigrid built from JAX's plain
    pieces (its Pallas multi-step inverse is estimate_inverse_window)."""
    dims = psi.shape[1:]
    ident = jf.identity_field(dims)
    dims_c = tuple(d // 2 for d in dims)
    ident_c = jf.identity_field(dims_c)
    K_c = max(1, -(-K // 2))
    disp_c = js._resample_disp(psi - ident, dims_c, 0.5)
    init_c = None
    if init is not None:
        init_c = init if init.shape[1:] == dims_c else (
            ident_c + js._resample_disp(init - ident, dims_c, 0.5))
    q_c = jf.estimate_inverse_window(ident_c + disp_c, iters, K_c, init=init_c)
    if return_coarse:
        return q_c
    q0 = ident + js._resample_disp(q_c - ident_c, dims, 2.0)
    if fine_iters == 0:
        return q0
    return jf.estimate_inverse_window(psi, fine_iters, K, init=q0)


# (init: None / "full" / "half", fine_iters, return_coarse)
MULTIGRID_CASES = [(None, 1, False), ("full", 1, False), ("half", 1, False),
                   ("full", 0, False), ("full", 0, True), ("half", 0, True)]


@pytest.mark.parametrize("init,fine_iters,return_coarse", MULTIGRID_CASES)
def test_multigrid_inverse_matches_jax_pieces(init, fine_iters, return_coarse):
    """Sub-voxel smooth-ish displacements keep both fixed points
    contractions: atol 1e-5."""
    dims = (16, 16, 16)
    psi = _rng_field(dims, 0.4, 11)
    init_a = None
    if init == "full":
        init_a = _rng_field(dims, 0.3, 12)
    elif init == "half":
        init_a = _rng_field((8, 8, 8), 0.2, 13)
    got = tp.estimate_inverse_multigrid(
        torch.from_numpy(psi), 3, 2, None if init_a is None else torch.from_numpy(init_a),
        fine_iters=fine_iters, return_coarse=return_coarse,
    )
    want = _jax_multigrid(jnp.asarray(psi), 3, 2, None if init_a is None else jnp.asarray(init_a),
                          fine_iters, return_coarse)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _fixture(shift=0.118, alpha=0.1, w_reg=0.3, max_iter=32, thresh=-1.0):
    tg, wg = init_sphere(DIMS, (VS,) * 3, (0.125, 0.125, 0.125), 0.04, 8 * VS, 3 * VS)
    tn, wn = init_sphere(DIMS, (VS,) * 3, (shift, 0.125, 0.125), 0.04, 8 * VS, 3 * VS)
    taps = ts.sobolev_filter_1d(7, 0.1)
    return (tf.identity_field(DIMS), tg, wg, tn, wn, taps, alpha, w_reg, max_iter, thresh)


def _jax_fixture(shift=0.118, alpha=0.1, w_reg=0.3, max_iter=32, thresh=-1.0):
    tg, wg = j_init_sphere(DIMS, (VS,) * 3, (0.125, 0.125, 0.125), 0.04, 8 * VS, 3 * VS)
    tn, wn = j_init_sphere(DIMS, (VS,) * 3, (shift, 0.125, 0.125), 0.04, 8 * VS, 3 * VS)
    taps = jnp.asarray(js.sobolev_filter_1d(7, 0.1))
    return (jf.identity_field(DIMS), tg, wg, tn, wn, taps, jnp.float32(alpha),
            jnp.float32(w_reg), jnp.int32(max_iter), jnp.float32(thresh))


def test_pyramid_matches_golden():
    """tests/test_golden.py's pyramid case (levels=2, K=2, 8 inverse steps)
    at its atol 1e-5; 32 iterations on each level."""
    res = ts.estimate_psi_pyramid(*_fixture(), levels=2, warp_window=2, inverse_iters=8)
    g = np.load(os.path.join(GOLDEN_DIR, "solver_16_pyramid.npz"))
    np.testing.assert_allclose(res.psi.numpy(), g["psi"], atol=1e-5)
    np.testing.assert_allclose(res.tsdf_n_psi.numpy(), g["tnp"], atol=1e-5)
    np.testing.assert_allclose(res.psi_inv.numpy(), g["psi_inv"], atol=1e-5)
    np.testing.assert_allclose(res.max_norm, float(g["max_norm"]), rtol=1e-4)
    assert (res.iters, res.coarse_iters) == (64, 32)


# the production solver keys at 16^3: momentum 0.95 with ALPHA 0.05, the
# stall stop (16, 1e-2), a 2-level pyramid. Case 1: the coarse level stops
# on its threshold and the fine level on the stall; case 2: both on the
# threshold.
PROD = dict(levels=2, warp_window=2, momentum=0.95, stall_window=16, stall_rel=1e-2,
            inverse_iters=3)
PYRAMID_CASES = {"stall": (0.118, 1e-3), "thresh": (0.110, 4e-3)}


@pytest.fixture(scope="module", params=sorted(PYRAMID_CASES))
def pyramid_runs(request):
    """(port result, JAX result, JAX's per-level iteration counts)."""
    shift, thresh = PYRAMID_CASES[request.param]
    kw = dict(shift=shift, alpha=0.05, w_reg=0.2, max_iter=200, thresh=thresh)
    port = ts.estimate_psi_pyramid(*_fixture(**kw), **PROD)
    level_iters = []
    orig = js.estimate_psi

    def spy(*a, **k):
        out = orig(*a, **k)
        level_iters.append(int(out.iters))
        return out

    js.estimate_psi = spy  # estimate_psi_pyramid calls it through the module
    try:
        want = js.estimate_psi_pyramid(*_jax_fixture(**kw), fused_db=False, **PROD)
    finally:
        js.estimate_psi = orig
    return port, want, level_iters


def test_pyramid_iterations_match_jax(pyramid_runs):
    """The same coarse and fine iteration counts, below the cap."""
    port, want, (coarse, fine) = pyramid_runs
    assert port.coarse_iters == coarse
    assert port.iters - port.coarse_iters == fine
    assert port.iters == int(want.iters) < 400
    np.testing.assert_allclose(port.max_norm, float(want.max_norm), rtol=1e-4)


def test_pyramid_fields_match_jax(pyramid_runs):
    port, want, _ = pyramid_runs
    np.testing.assert_allclose(port.psi.numpy(), np.asarray(want.psi), atol=1e-5)
    np.testing.assert_allclose(port.tsdf_n_psi.numpy(), np.asarray(want.tsdf_n_psi),
                               atol=1e-5)
    np.testing.assert_allclose(port.psi_inv.numpy(), np.asarray(want.psi_inv), atol=1e-5)


def test_pyramid_coarse_x64_level_runs_gd_multi(monkeypatch):
    """Fine 16x16x128 -> coarse 8x8x64: with the fused dispatch the coarse
    level runs kernel E in chunks of 16 (its plain version on the CPU) and
    stops on a chunk boundary; without it, kernel A step by step."""
    dims = (16, 16, 128)
    rng = np.random.default_rng(5)
    tg = torch.from_numpy(rng.standard_normal(dims).astype(np.float32) * 0.1)
    tn = torch.from_numpy(np.roll(tg.numpy(), 1, axis=2))
    calls = []
    orig = kernels.gd_multi

    def spy(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(kernels, "gd_multi", spy)
    args = (tf.identity_field(dims), tg, tg, tn, tn, ts.sobolev_filter_1d(7, 0.1), 0.05, 0.2,
            40, 1e-3)
    kw = dict(levels=2, warp_window=2, momentum=0.95, inverse_iters=2, stall_window=16,
              stall_rel=1e-2)
    fused = ts.estimate_psi_pyramid(*args, fused=True, **kw)
    assert calls and all(tuple(s) == (3, 8, 8, 64) for s in calls)
    assert fused.coarse_iters % 16 == 0 and fused.coarse_iters == 16 * len(calls)
    calls.clear()
    plain = ts.estimate_psi_pyramid(*args, fused=False, **kw)
    assert not calls
    assert plain.coarse_iters <= fused.coarse_iters < plain.coarse_iters + 16


@pytest.mark.parametrize("dims,fused,want", [((8, 8, 64), True, True),
                                             ((16, 16, 64), True, True),
                                             ((8, 8, 64), False, False),
                                             ((4, 8, 64), True, False),
                                             ((8, 7, 64), True, False),
                                             ((8, 8, 128), True, False)])
def test_runs_gd_multi_rule(dims, fused, want):
    """JAX's fold rule: X = 64, Y even, Z % 8 == 0, on the fused path."""
    assert ts.runs_gd_multi(dims, fused) is want


@pytest.mark.parametrize("dim", [32, 64, 128, 256])
@pytest.mark.parametrize("warm,no_log", [(True, True), (False, True), (True, False)])
def test_production_pyramid_kwargs_match_jax(dim, warm, no_log):
    """The same configuration less the TPU layout keys; ``fused`` stands
    in fused_db's place."""
    got = ts.production_pyramid_kwargs(dim, warm=warm, no_log=no_log)
    want = js.production_pyramid_kwargs(dim, warm=warm, no_log=no_log)
    fused_db = want.pop("fused_db")
    for key in ("conv_mxu", "fold_xmats"):
        want.pop(key)
    assert got.pop("fused") == fused_db
    assert got == want
