"""Parity of sobfu_tpu_torch.fields with sobfu_tpu.fields on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
(CPU backend) and its torch counterpart. Stencils, samplers and the inverse
fixed point evaluate the same f32 operations in the same order, so they
agree to the last bit or to a few ulps; floor-corner sampling moves values
without arithmetic and is compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import fields as jf
from sobfu_tpu_torch import fields as tf

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

# one cubic grid and one non-cubic grid: a (z*Y + y)*X + x indexing slip
# (the reference's get_global_idx uses dim_y*dim_y) shows only off-cube
GRIDS = [(16, 16, 16), (12, 16, 20)]
# f32 results of identical operation sequences; ulp-level slack only for
# reassociation inside XLA's fused loops
ATOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _psi(dims, amp, seed=0):
    ident = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")[::-1])
    return (ident + _rng(seed).uniform(-amp, amp, (3,) + dims)).astype(np.float32)


def _vol(dims, seed=1, lead=()):
    return _rng(seed).standard_normal(lead + dims).astype(np.float32)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("dims", GRIDS)
def test_identity_and_displacement(dims):
    np.testing.assert_array_equal(_np(tf.identity_field(dims)), _np(jf.identity_field(dims)))
    psi = _psi(dims, 2.0)
    np.testing.assert_array_equal(
        _np(tf.displacement(torch.from_numpy(psi))), _np(jf.displacement(jnp.asarray(psi)))
    )


@pytest.mark.parametrize("dims", GRIDS)
def test_stencils_match_jax(dims):
    v = _vol(dims)
    psi = _psi(dims, 1.5)
    t, j = torch.from_numpy(v), jnp.asarray(v)
    for axis in range(3):
        np.testing.assert_allclose(
            _np(tf.central_diff(t, axis)), _np(jf.central_diff(j, axis)), atol=ATOL
        )
        np.testing.assert_allclose(
            _np(tf.second_diff(t, axis)), _np(jf.second_diff(j, axis)), atol=ATOL
        )
    np.testing.assert_allclose(_np(tf.tsdf_gradient(t)), _np(jf.tsdf_gradient(j)), atol=ATOL)
    np.testing.assert_allclose(
        _np(tf.neg_laplacian(torch.from_numpy(psi))),
        _np(jf.neg_laplacian(jnp.asarray(psi))), atol=ATOL,
    )
    np.testing.assert_allclose(
        _np(tf.deformation_jacobian(torch.from_numpy(psi))),
        _np(jf.deformation_jacobian(jnp.asarray(psi))), atol=ATOL,
    )


@pytest.mark.parametrize("s", [3, 7, 11])
def test_conv1d_replicate_matches_jax(s):
    from sobfu_tpu.solver import sobolev_filter_1d

    taps = sobolev_filter_1d(s, 0.1)
    v = _vol((12, 16, 20), lead=(3,))
    for axis in (-1, -2, -3):
        np.testing.assert_allclose(
            _np(tf.conv1d_replicate(torch.from_numpy(v), torch.from_numpy(taps), axis)),
            _np(jf.conv1d_replicate(jnp.asarray(v), jnp.asarray(taps), axis)),
            atol=ATOL,
        )


@pytest.mark.parametrize("dims", GRIDS)
def test_exact_samplers_match_jax(dims):
    """Coordinates reach 3 voxels past the grid on every side: the clamp
    to [0, dim-1] and x1 = min(x0+1, X-1) are exercised."""
    v = _vol(dims, lead=(3,))
    c = _rng(5).uniform(-3.0, max(dims) + 3.0, (3, 7, 9)).astype(np.float32)
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    tc, jc = torch.from_numpy(c), jnp.asarray(c)
    np.testing.assert_allclose(
        _np(tf.sample_trilinear(tv[0], tc)), _np(jf.sample_trilinear(jv[0], jc)), atol=ATOL
    )
    np.testing.assert_allclose(
        _np(tf.sample_field_trilinear(tv, tc)), _np(jf.sample_field_trilinear(jv, jc)),
        atol=ATOL,
    )
    # floor rule: a pure gather, bit for bit
    np.testing.assert_array_equal(
        _np(tf.sample_nearest_floor(tv[0], tc)), _np(jf.sample_nearest_floor(jv[0], jc))
    )


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("dims", GRIDS)
def test_window_samplers_match_jax(dims, K):
    """Displacements up to 3 voxels: part of the field leaves the window,
    so both clamps (coordinate, then displacement) are exercised."""
    v = _vol(dims, lead=(2,))
    psi = _psi(dims, 3.0)
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    tp, jp = torch.from_numpy(psi), jnp.asarray(psi)
    np.testing.assert_allclose(
        _np(tf.sample_trilinear_window(tv, tp, K)), _np(jf.sample_trilinear_window(jv, jp, K)),
        atol=ATOL,
    )
    np.testing.assert_array_equal(
        _np(tf.sample_nearest_floor_window(tv, tp, K)),
        _np(jf.sample_nearest_floor_window(jv, jp, K)),
    )


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("K", [None, 2])
def test_inverse_matches_jax(K, warm):
    """Fixed-point inverse, cold and warm-started. Displacements of at most
    0.3 voxel keep the iteration a contraction (|d disp / dx| < 1), as for
    the smooth fields the solver produces, so 8 steps of ulp-level
    differences stay below 1e-5."""
    dims = (12, 16, 20)
    psi = _psi(dims, 0.3)
    init = _psi(dims, 0.2, seed=3) if warm else None
    tp, jp = torch.from_numpy(psi), jnp.asarray(psi)
    ti = None if init is None else torch.from_numpy(init)
    ji = None if init is None else jnp.asarray(init)
    if K is None:
        got = tf.estimate_inverse(tp, 8, init=ti)
        want = jf.estimate_inverse(jp, 8, init=ji)
    else:
        got = tf.estimate_inverse_window(tp, 8, K, init=ti)
        want = jf.estimate_inverse_window(jp, 8, K, init=ji)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_deformation_field_wrapper():
    df = tf.DeformationField((20, 16, 12), device="cpu")
    assert tuple(df.data.shape) == (3, 12, 16, 20)
    df.data = df.data + 0.25
    assert df.no_nans()
    inv = df.get_inverse(iters=4)
    # a uniform shift inverts to the opposite shift away from the clamped border
    np.testing.assert_allclose(_np(inv.get_displacement())[:, 2:-2, 2:-2, 2:-2], -0.25,
                               atol=1e-6)
    t, w = df.apply(torch.zeros(12, 16, 20), torch.ones(12, 16, 20))
    assert float(w.min()) == 1.0 and float(t.abs().max()) == 0.0
    df.clear()
    assert float(df.get_displacement().abs().max()) == 0.0


@pytest.mark.parametrize("dims", GRIDS)
def test_warp_tsdf_and_interpolated_derivatives_match_jax(dims):
    """warp_tsdf (trilinear tsdf, floor-corner weight), interpolate_gradient
    and interpolate_laplacian at a psi reaching 2.5 voxels, past the border
    on every side. The weight is a gather, bit for bit; the warp and the
    gradient within ATOL (measured 3.6e-7); the Laplacian of unit-normal
    values reaches 20, where an ulp is 1.9e-6: within 1e-5 (measured
    2.9e-6)."""
    v = _vol(dims, lead=(2,))
    w = np.round(np.abs(v[1]) * 3).astype(np.float32)
    field = _vol(dims, seed=4, lead=(3,))
    psi = _psi(dims, 2.5, seed=2)
    tp, jp = torch.from_numpy(psi), jnp.asarray(psi)
    gt, gw = tf.warp_tsdf(torch.from_numpy(v[0]), torch.from_numpy(w), tp)
    wt, ww = jf.warp_tsdf(jnp.asarray(v[0]), jnp.asarray(w), jp)
    np.testing.assert_allclose(_np(gt), _np(wt), atol=ATOL)
    np.testing.assert_array_equal(_np(gw), _np(ww))
    np.testing.assert_allclose(_np(tf.interpolate_gradient(torch.from_numpy(v[0]), tp)),
                               _np(jf.interpolate_gradient(jnp.asarray(v[0]), jp)), atol=ATOL)
    np.testing.assert_allclose(_np(tf.interpolate_laplacian(torch.from_numpy(field), tp)),
                               _np(jf.interpolate_laplacian(jnp.asarray(field), jp)), atol=1e-5)
    # warp_tsdf is DeformationField.apply's rule (kernel B's plain version on the CPU)
    at, aw = tf.DeformationField(dims[::-1], tp).apply(torch.from_numpy(v[0]), torch.from_numpy(w))
    np.testing.assert_array_equal(_np(at), _np(gt))
    np.testing.assert_array_equal(_np(aw), _np(gw))
