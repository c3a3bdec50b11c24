"""Preprocessing and TSDF parity: sobfu_tpu_torch against sobfu_tpu on the CPU.

Depth maps are rendered with numpy (tools/make_synthetic_scene's
render_prims_depth) and fed to both packages.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import tsdf as jt
from sobfu_tpu.config import Intr, translation_pose
from sobfu_tpu.ops import imgproc as ji
from sobfu_tpu_torch import tsdf as tt
from sobfu_tpu_torch.ops import imgproc as ti

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
from make_synthetic_scene import render_prims_depth  # noqa: E402

H, W = 120, 160
INTR = Intr(140.0, 140.0, W / 2 - 0.5, H / 2 - 0.5)


def _depth(seed=0):
    """Two spheres plus sensor-like noise: edges, holes and a smooth surface."""
    d = render_prims_depth(H, W, *INTR, [((0.0, 0.0, 0.5), 0.12), ((0.08, -0.05, 0.38), 0.03)])
    rng = np.random.default_rng(seed)
    noisy = d.astype(np.float64) + rng.normal(0.0, 2.0, d.shape) * (d > 0)
    return np.clip(np.round(noisy), 0, 65535).astype(np.uint16)


def test_bilateral_filter_matches_jax():
    """exp() differs by an ulp between XLA and torch, which can move a
    rounded value by 1 mm: at most 1 mm apart, on at most 0.1% of pixels."""
    d = _depth()
    want = np.asarray(ji.bilateral_filter(jnp.asarray(d), 7, 4.5, 0.04)).astype(np.int64)
    got = ti.bilateral_filter(torch.from_numpy(d.astype(np.int32)), 7, 4.5, 0.04)
    diff = np.abs(got.numpy().astype(np.int64) - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_truncate_depth_and_dists_match_jax():
    d = _depth(1)
    want = np.asarray(ji.truncate_depth(jnp.asarray(d), jnp.float32(0.45)))
    got = ti.truncate_depth(torch.from_numpy(d.astype(np.int32)), 0.45)
    np.testing.assert_array_equal(got.numpy(), want)
    intr = np.asarray(INTR, np.float32)
    want_d = np.asarray(ji.compute_dists(jnp.asarray(want), jnp.asarray(intr)))
    got_d = ti.compute_dists(got, INTR)
    # elementwise f32 with the same op order; XLA may fuse the product chain
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=2e-7, atol=0)


def _integrate_both(pose, dims=(24, 28, 32)):
    d = _depth(2)
    intr = np.asarray(INTR, np.float32)
    dists = np.array(ji.compute_dists(jnp.asarray(d), jnp.asarray(intr)))
    vs = (0.4 / dims[2], 0.4 / dims[1], 0.4 / dims[0])  # x, y, z
    vol_pose = translation_pose((-0.2, -0.2, 0.3))
    vol2cam = (np.linalg.inv(pose.astype(np.float32)) @ vol_pose).astype(np.float32)
    aligned = bool(np.allclose(vol2cam[:3, :3], np.eye(3), atol=1e-6))
    z = jnp.zeros(dims, jnp.float32)
    want = jt.integrate_dists(
        z, z, jnp.asarray(dists), jnp.asarray(vol2cam), jnp.asarray(intr),
        jnp.asarray(vs, jnp.float32), jnp.float32(6 * vs[0]), jnp.float32(2 * vs[0]),
        dims, axis_aligned=aligned,
    )
    zt = torch.zeros(dims)
    got = tt.integrate_dists(
        zt, zt, torch.from_numpy(dists), vol2cam, INTR, vs, 6 * vs[0], 2 * vs[0],
        axis_aligned=aligned,
    )
    return aligned, got, want


def test_integrate_axis_aligned_bitwise():
    """The rotation-free pose: the port's direct index reproduces the JAX
    separable path's arithmetic, so tsdf and weight match bit for bit."""
    aligned, got, want = _integrate_both(np.eye(4))
    assert aligned
    assert float(want[1].sum()) > 100  # the surface was seen
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_integrate_rotated_pose_matches_jax():
    """General path (rotated camera): the rotation is an einsum whose sum
    order differs between XLA and torch, so a projection can land across a
    pixel edge. Values agree to 1e-5 on all but 0.5% of voxels."""
    a = np.deg2rad(4.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    aligned, got, want = _integrate_both(pose)
    assert not aligned
    bad_t = np.abs(got[0].numpy() - np.asarray(want[0])) > 1e-5
    bad_w = got[1].numpy() != np.asarray(want[1])
    assert float(want[1].sum()) > 100
    assert bad_t.mean() <= 5e-3 and bad_w.mean() <= 5e-3


def test_fuse_volumes_bitwise():
    """The running average, skip rules included, bit for bit (the numerator
    is one fused multiply-add in both packages)."""
    rng = np.random.default_rng(3)
    dims = (12, 16, 20)
    tg = rng.standard_normal(dims).astype(np.float32)
    wg = rng.integers(0, 130, dims).astype(np.float32)
    tn = rng.standard_normal(dims).astype(np.float32)
    tn[rng.random(dims) < 0.1] = 0.0
    tn[rng.random(dims) < 0.1] = -1.0
    wn = rng.integers(0, 3, dims).astype(np.float32)
    want = jt.fuse_volumes(*(jnp.asarray(a) for a in (tg, wg, tn, wn)), jnp.float32(128.0))
    got = tt.fuse_volumes(*(torch.from_numpy(a) for a in (tg, wg, tn, wn)), 128.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_init_sphere_matches_jax():
    """The golden fixture's sphere: norm() sums 3 squares in another order,
    an ulp apart at most."""
    dims = (16, 16, 16)
    vs = 0.25 / 16
    want = jt.init_sphere(dims, (vs,) * 3, (0.118, 0.125, 0.125), 0.04, 8 * vs, 3 * vs)
    got = tt.init_sphere(dims, (vs,) * 3, (0.118, 0.125, 0.125), 0.04, 8 * vs, 3 * vs)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_tsdf_volume_wrapper():
    from sobfu_tpu_torch.config import Params

    p = Params()
    p.volume_dims = (20, 16, 12)
    vol = tt.TsdfVolume(p, device="cpu")
    assert vol.dims_zyx == (12, 16, 20) and tuple(vol.tsdf.shape) == (12, 16, 20)
    vol.init_sphere((0.5, 0.5, 0.5), 0.3)
    other = tt.TsdfVolume(p, device="cpu")
    other.tsdf, other.weight = vol.tsdf.clone(), vol.weight.clone()
    vol.integrate_volume(other)
    assert float(vol.weight.max()) == 2.0
    vol.clear()
    assert float(vol.weight.abs().max()) == 0.0


INIT_DIMS = [(16, 16, 16), (20, 24, 28)]


@pytest.mark.parametrize("dims", INIT_DIMS)
def test_analytic_initialisers_match_jax(dims):
    """init_box / init_ellipsoid / init_plane / init_torus at 16^3 and a
    non-cubic grid: the same f32 operations in the same order, an ulp of
    a norm's sum apart at most (held at 1e-6); weights all ones."""
    vs = (0.3 / dims[2], 0.3 / dims[1], 0.3 / dims[0])
    trunc = 5 * vs[0]
    cases = [
        ("init_box", ((0.06, 0.08, 0.05), trunc)),
        ("init_ellipsoid", ((0.09, 0.06, 0.07), trunc)),
        ("init_plane", (0.13, trunc)),
        ("init_torus", (0.08, 0.03, trunc)),
    ]
    for name, args in cases:
        want = getattr(jt, name)(dims, vs, *args)
        got = getattr(tt, name)(dims, vs, *args, device="cpu")
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert float(got[0].min()) < 0 < float(got[0].max()), name  # a surface inside


def test_volume_inits_affine_swap_and_print(capsys):
    """TsdfVolume.init_* against the JAX volume's, apply_affine, swap and
    print_sdf_values."""
    from sobfu_tpu.config import Params as JParams
    from sobfu_tpu_torch.config import Params

    p, jp = Params(), JParams()
    for q in (p, jp):
        q.volume_dims, q.volume_size = (20, 16, 12), (0.4, 0.32, 0.24)
        q.tsdf_trunc_dist, q.eta = 0.06, 0.02
        q.volume_pose = translation_pose((-0.2, -0.16, 0.3))
    vol, jvol = tt.TsdfVolume(p, device="cpu"), jt.TsdfVolume(jp)
    for name, args in (("init_box", ((0.1, 0.08, 0.05),)), ("init_ellipsoid", ((0.1, 0.07, 0.06),)),
                       ("init_plane", (0.1,)), ("init_torus", (0.1, 0.03))):
        getattr(vol, name)(*args)
        getattr(jvol, name)(*args)
        np.testing.assert_allclose(vol.tsdf.numpy(), np.asarray(jvol.tsdf), atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(vol.weight.numpy(), np.asarray(jvol.weight))
        assert vol.tsdf.device.type == "cpu"
    A = np.eye(4, dtype=np.float32)
    A[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    A[:3, 3] = (0.1, 0.2, -0.05)
    vol.apply_affine(A)
    jvol.apply_affine(A)
    assert vol.pose.dtype == np.float32
    np.testing.assert_array_equal(vol.pose, jvol.pose)
    other = tt.TsdfVolume(p, device="cpu")
    other.init_sphere((0.2, 0.16, 0.12), 0.05)
    a_t, b_t = vol.tsdf, other.tsdf
    vol.swap(other)
    assert vol.tsdf is b_t and other.tsdf is a_t
    jvol.tsdf = jnp.asarray(vol.tsdf.numpy())
    outs = []
    for call in (lambda: vol.print_sdf_values(), lambda: vol.print_sdf_values(6),
                 lambda: jvol.print_sdf_values(3), lambda: vol.print_sdf_values(3)):
        call()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[2] == outs[3]  # the middle slice by default; JAX's text
