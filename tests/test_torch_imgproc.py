"""Depth pyramids, normal and point maps, the rasteriser and the renderers:
sobfu_tpu_torch.ops.imgproc against sobfu_tpu.ops.imgproc on the CPU, and
the analytic oracles of tests/test_imgproc.py run on the port.

Inputs: tests/test_icp.py's height field rendered at 64 x 80, with a
raised block (depth edges), seeded sensor noise and seeded holes. Integer
outputs are compared bit for bit; float maps within 1e-6 with the same NaN
positions (measured: point maps 0 apart, normals at most 1.2e-7 on under
1% of pixels, where XLA's reduction of a norm rounds differently); the
uint8 renders bit for bit (measured: equal on four seeds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu.ops import imgproc as ji
from sobfu_tpu_torch.ops import imgproc as ti
from tests.test_icp import INTR as ICP_INTR
from tests.test_icp import render_scene_depth

torch.set_num_threads(1)

H, W = 64, 80
INTR = tuple(float(v) for v in ICP_INTR)


def _depth(seed=0) -> np.ndarray:
    d = render_scene_depth(np.eye(4)).astype(np.float64)
    d[20:36, 30:52] -= 180.0  # a raised block: depth edges
    rng = np.random.default_rng(seed)
    d += rng.normal(0.0, 1.5, d.shape)
    d[rng.random(d.shape) < 0.03] = 0.0  # holes
    return np.clip(np.round(d), 0, 65535).astype(np.uint16)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16 else a.copy())


def _j_intr(intr=INTR):
    return jnp.asarray(intr, jnp.float32)


def _close_nan(got: torch.Tensor, want, atol: float) -> None:
    """Equal NaN positions, finite values within atol."""
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    np.testing.assert_allclose(g[ok], w[ok], atol=atol, rtol=0)


@pytest.mark.parametrize("dy,dx,pad", [(0, 1, 0.0), (1, 0, 0.0), (-2, 3, float("nan")),
                                       (2, -1, 7.0)])
def test_shift2d_matches_jax(dy, dx, pad):
    """_shift2d on [H, W] and [H, W, 3] maps with a pad value."""
    a = np.random.default_rng(1).standard_normal((H, W, 3)).astype(np.float32)
    for x in (a, a[..., 0]):
        want = np.asarray(ji._shift2d(jnp.asarray(x), dy, dx, pad_value=pad))
        got = ti._shift2d(torch.from_numpy(x.copy()), dy, dx, pad_value=pad).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_pyramid_down_bitwise(seed):
    d = _depth(seed)
    want = np.asarray(ji.depth_pyramid_down(jnp.asarray(d), jnp.float32(0.04)))
    got = ti.depth_pyramid_down(_t(d), 0.04)
    assert got.dtype == torch.int32 and tuple(got.shape) == (H // 2, W // 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    # and one more level down, from the JAX result
    want2 = np.asarray(ji.depth_pyramid_down(jnp.asarray(want), jnp.float32(0.04)))
    np.testing.assert_array_equal(ti.depth_pyramid_down(got, 0.04).numpy(), want2)


def test_reproject_and_normals_match_jax():
    """_reproject on a metric map (JAX eagerly) and the normals (measured:
    at most 1.2e-7 apart)."""
    d = _depth()
    dm = d.astype(np.float32) * np.float32(0.001)
    want = np.asarray(ji._reproject(jnp.asarray(dm), _j_intr()))
    got = ti._reproject(torch.from_numpy(dm), INTR)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    _close_nan(ti.compute_normals(_t(d), INTR), ji.compute_normals(jnp.asarray(d), _j_intr()),
               1e-6)


def test_points_normals_and_mask_depth_match_jax():
    d = _depth(2)
    wp, wn = ji.compute_points_normals(jnp.asarray(d), _j_intr())
    gp, gn = ti.compute_points_normals(_t(d), INTR)
    _close_nan(gp, wp, 1e-6)
    _close_nan(gn, wn, 1e-6)
    want = np.asarray(ji.mask_depth(jnp.asarray(d), wn))
    got = ti.mask_depth(_t(d), gn)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert (want == 0).sum() > (d == 0).sum()  # the mask removed more than the holes


def test_resizes_match_jax():
    d = _depth(3)
    wp, wn = ji.compute_points_normals(jnp.asarray(d), _j_intr())
    gp, gn = ti.compute_points_normals(_t(d), INTR)
    wd2, wn2 = ji.resize_depth_normals(jnp.asarray(d), wn)
    gd2, gn2 = ti.resize_depth_normals(_t(d), gn)
    np.testing.assert_array_equal(gd2.numpy(), np.asarray(wd2).astype(np.int32))
    _close_nan(gn2, wn2, 1e-6)
    wp2, wn3 = ji.resize_points_normals(wp, wn)
    gp2, gn3 = ti.resize_points_normals(gp, gn)
    _close_nan(gp2, wp2, 1e-6)
    _close_nan(gn3, wn3, 1e-6)


def _soup(seed=4, n=40):
    """A seeded triangle soup in front of the camera, with one NaN triangle."""
    rng = np.random.default_rng(seed)
    centres = np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-0.15, 0.15, n),
                        rng.uniform(0.5, 0.9, n)], axis=1)
    tri = centres[:, None, :] + rng.uniform(-0.06, 0.06, (n, 3, 3))
    tri[5] = np.nan
    return tri.reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("rot", [0.0, 0.1])
def test_rasterise_surface_matches_jax(rot):
    """Overlapping triangles: the z-test picks the same winner as JAX's
    scatter (the last sample in order among equal z). Measured: points 0
    apart, normals at most 1.2e-7 (a pixel whose neighbours are empty
    crosses a vector with itself: both packages give the rounding residue
    of one fused multiply-add there, not 0)."""
    verts = _soup()
    pose = np.eye(4, dtype=np.float32)
    c, s = np.cos(rot), np.sin(rot)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    intr = np.asarray(INTR, np.float32)
    wp, wn = ji.rasterise_surface(jnp.asarray(verts), jnp.asarray(pose), jnp.asarray(intr), H, W,
                                  samples_per_edge=6)
    gp, gn = ti.rasterise_surface(torch.from_numpy(verts), pose, INTR, H, W, samples_per_edge=6)
    wp = np.asarray(wp)
    assert (np.abs(wp[..., 2]) > 0).sum() > 200
    np.testing.assert_array_equal(gp.numpy()[..., 2] != 0, wp[..., 2] != 0)
    np.testing.assert_allclose(gp.numpy(), wp, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=1e-6, rtol=0)


def test_render_tangent_colors_and_image_match_jax():
    d = _depth(5)
    wp, wn = ji.compute_points_normals(jnp.asarray(d), _j_intr())
    gp, gn = ti.compute_points_normals(_t(d), INTR)
    want = np.asarray(ji.render_tangent_colors(wn))
    got = ti.render_tangent_colors(gn)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (H, W, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    light = (0.3, -0.2, 0.0)
    want = np.asarray(ji.render_image(wp, wn, jnp.asarray(light, jnp.float32)))
    got = ti.render_image(gp, gn, light)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (H, W, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 150


# ---------------------------------------------------------------------------
# tests/test_imgproc.py's analytic oracles, on the port
# ---------------------------------------------------------------------------

OH, OW = 32, 48
OINTR = (40.0, 40.0, OW / 2.0, OH / 2.0)


def test_oracle_depth_pyramid_constant():
    out = ti.depth_pyramid_down(torch.full((OH, OW), 800, dtype=torch.int32), 0.04)
    assert tuple(out.shape) == (OH // 2, OW // 2)
    assert bool((out == 800).all())


def test_oracle_normals_of_flat_wall_point_at_camera():
    n = ti.compute_normals(torch.full((OH, OW), 1000, dtype=torch.int32), OINTR).numpy()
    inner = n[1:-1, 1:-1]
    assert np.isfinite(inner).all()
    np.testing.assert_allclose(np.abs(inner[..., 2]), 1.0, atol=1e-3)


def test_oracle_mask_depth_zeroes_invalid():
    d = torch.full((OH, OW), 1000, dtype=torch.int32)
    out = ti.mask_depth(d, torch.full((OH, OW, 3), float("nan")))
    assert int(out.abs().max()) == 0


def test_oracle_resize_depth_normals_halves():
    n = torch.zeros((OH, OW, 3))
    n[..., 2] = -1.0
    d2, n2 = ti.resize_depth_normals(torch.full((OH, OW), 900, dtype=torch.int32), n)
    assert tuple(d2.shape) == (OH // 2, OW // 2)
    assert bool((d2 == 900).all())
    np.testing.assert_allclose(n2.numpy()[..., 2], -1.0)


def test_oracle_rasterise_surface_projects_triangle():
    z = 0.5
    verts = torch.tensor([[-0.05, -0.05, z], [0.05, -0.05, z], [0.0, 0.08, z]])
    pts, _ = ti.rasterise_surface(verts, np.eye(4), OINTR, OH, OW, samples_per_edge=8)
    pts = pts.numpy()
    hit = np.abs(pts[..., 2]) > 0
    assert hit.sum() > 3
    np.testing.assert_allclose(pts[hit][:, 2], z, atol=1e-5)


def test_oracle_render_tangent_colors():
    n = torch.zeros((8, 8, 3))
    n[..., 2] = -1.0
    n[0, 0] = float("nan")
    img = ti.render_tangent_colors(n).numpy()
    assert img.dtype == np.uint8
    assert (img[0, 0] == 0).all()  # invalid -> black
    assert abs(int(img[4, 4, 0]) - 127) <= 1  # n = (0,0,-1) -> (127, 127, 0)
    assert img[4, 4, 2] == 0


def test_oracle_render_image_shades_flat_wall():
    pts, normals = ti.compute_points_normals(torch.full((OH, OW), 1000, dtype=torch.int32),
                                             OINTR)
    img = ti.render_image(pts, normals, (0.0, 0.0, 0.0)).numpy()
    assert img[1:-2, 1:-2].max() > 150  # lit
    assert (img[-1] == 0).all()  # last row invalid -> black
