"""Rigid projective ICP: sobfu_tpu_torch.icp against sobfu_tpu.icp on the
CPU, on tests/test_icp.py's height-field scene, and that file's oracles
run on the port.

Tolerances: rotation matrices within 1e-6, poses within 1e-5 with the same
success flag (measured: 0 on the identity, at most 4.4e-8 under a small
rotation and translation; the 7x7 normal system is summed in another order
than XLA's, and the SVD is another LAPACK call).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import icp as jicp
from sobfu_tpu.ops import imgproc as ji
from sobfu_tpu_torch import icp as ticp
from sobfu_tpu_torch.config import Intr
from tests.test_icp import INTR as J_INTR
from tests.test_icp import render_scene_depth

torch.set_num_threads(1)

INTR = Intr(*J_INTR)


def _pose(rot_y=0.0, t=(0.0, 0.0, 0.0)):
    T = np.eye(4)
    c, s = np.cos(rot_y), np.sin(rot_y)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[:3, 3] = t
    return T


SCENES = {
    "identity": _pose(),
    "translation": _pose(0.0, (0.004, -0.003, 0.006)),
    "rotation": _pose(0.01, (0.003, 0.002, -0.004)),
}


def _t(d: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(d.astype(np.int32))


def test_rodrigues_matches_jax():
    for r in ([0.02, -0.015, 0.03], [0.0, 0.0, 0.0], [1e-13, 0.0, 0.0], [0.4, 0.9, -0.3]):
        r = np.asarray(r, np.float32)
        want = np.asarray(jicp.rodrigues(jnp.asarray(r)))
        got = ticp.rodrigues(torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        t = np.asarray([0.1, -0.2, 0.3], np.float32)
        np.testing.assert_array_equal(
            ticp._affine(torch.from_numpy(want.copy()), torch.from_numpy(t)).numpy(),
            np.asarray(jicp._affine(jnp.asarray(want), jnp.asarray(t))))


def test_build_pyramid_matches_jax():
    """Three levels of depth (bit for bit), point and normal maps (1e-6,
    the same NaN positions) from one depth map."""
    d = render_scene_depth(SCENES["rotation"])
    jd, jp, jn = jicp.ProjectiveICP.build_pyramid(jnp.asarray(d), J_INTR, 3)
    td, tp, tn = ticp.ProjectiveICP.build_pyramid(_t(d), INTR, 3)
    for lvl in range(3):
        np.testing.assert_array_equal(td[lvl].numpy(), np.asarray(jd[lvl]).astype(np.int32))
        for g, w in ((tp[lvl], jp[lvl]), (tn[lvl], jn[lvl])):
            g, w = g.numpy(), np.asarray(w)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], atol=1e-6, rtol=0)
    assert tuple(tp[2].shape) == (16, 20, 3)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_icp_level_matches_jax(scene):
    """One level, 6 iterations from a perturbed start, on the finest maps."""
    d_prev = render_scene_depth(np.eye(4))
    d_curr = render_scene_depth(SCENES[scene])
    intr = np.asarray(J_INTR, np.float32)
    jp, jn = ji.compute_points_normals(jnp.asarray(d_prev), jnp.asarray(intr))
    jc, jcn = ji.compute_points_normals(jnp.asarray(d_curr), jnp.asarray(intr))
    tp, tn = ticp.imgproc.compute_points_normals(_t(d_prev), INTR)
    tc, tcn = ticp.imgproc.compute_points_normals(_t(d_curr), INTR)
    start = _pose(0.002, (0.001, 0.0, -0.001)).astype(np.float32)
    Tj, okj = jicp._icp_level(jnp.asarray(start), jc, jcn, jp, jn, jnp.asarray(intr),
                              jnp.float32(0.1 ** 2), jnp.float32(np.cos(np.deg2rad(20.0))), 6)
    Tt, okt = ticp._icp_level(torch.from_numpy(start), tc, tcn, tp, tn, INTR,
                              float(np.float32(0.1 ** 2)),
                              float(np.float32(np.cos(np.deg2rad(20.0)))), 6)
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5, rtol=0)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("iters", [(5, 3, 0, 0), (10, 5, 4, 0)])
def test_estimate_transform_matches_jax(scene, iters):
    """Coarse to fine from the depth maps: the pyramids, every level's
    iterations and the host-side flag, against JAX."""
    d0 = render_scene_depth(np.eye(4))
    d1 = render_scene_depth(SCENES[scene])
    j = jicp.ProjectiveICP()
    j.set_iterations(iters)
    Tj, okj = j.estimate_transform_from_depth(J_INTR, jnp.asarray(d1), jnp.asarray(d0))
    t = ticp.ProjectiveICP()
    t.set_iterations(iters)
    Tt, okt = t.estimate_transform_from_depth(INTR, _t(d1), _t(d0))
    assert isinstance(Tt, np.ndarray) and Tt.dtype == np.float32
    assert okt == okj
    np.testing.assert_allclose(Tt, Tj, atol=1e-5, rtol=0)


def test_flat_wall_is_rank_deficient_like_jax():
    """A fronto-parallel wall constrains 3 of 6 degrees of freedom: det A is
    0, so every iteration keeps the pose and the level fails, in both."""
    d = np.full((64, 80), 1000, np.uint16)
    j = jicp.ProjectiveICP()
    j.set_iterations([3, 2, 0, 0])
    Tj, okj = j.estimate_transform_from_depth(J_INTR, jnp.asarray(d), jnp.asarray(d))
    t = ticp.ProjectiveICP()
    t.set_iterations([3, 2, 0, 0])
    Tt, okt = t.estimate_transform_from_depth(INTR, _t(d), _t(d))
    assert okt is False and okj is False
    np.testing.assert_array_equal(Tt, np.asarray(Tj))
    np.testing.assert_array_equal(Tt, np.eye(4, dtype=np.float32))


@pytest.mark.parametrize("small", [0.0, 1e-9, 1e-8, 1e-3])
def test_lstsq_drops_the_singular_values_jax_drops(small):
    """The solve on a symmetric 6x6 system whose last two singular values
    sit well under (0, 1e-9, 1e-8: rank 4) or well over (1e-3: rank 6) the
    cutoff eps * 6 = 7.2e-7 of the largest: the rank and the minimum-norm
    solution of jnp.linalg.lstsq. In float32 the two SVDs agree to about
    3e-5 of the solution's size (measured 2.6e-5); held at 2e-4."""
    rng = np.random.default_rng(7)
    Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    s = np.array([3e4, 1e4, 2e3, 50.0, 3e4 * small, 3e4 * small * 0.5])
    A = ((Q * s) @ Q.T).astype(np.float32)
    A = (A + A.T) / 2
    b = rng.standard_normal(6).astype(np.float32) * 100
    want, _, rank, _ = jnp.linalg.lstsq(jnp.asarray(A), jnp.asarray(b))
    sv = torch.linalg.svdvals(torch.from_numpy(A))
    assert int((sv >= ticp.LSTSQ_RCOND * sv[0]).sum()) == int(rank) == (4 if small < 1e-6 else 6)
    got = ticp._lstsq(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# tests/test_icp.py's oracles, on the port
# ---------------------------------------------------------------------------


def test_oracle_rodrigues_roundtrip():
    rvec = torch.tensor([0.02, -0.015, 0.03])
    R = ticp.rodrigues(rvec).numpy()
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-5)
    angle = np.arccos((np.trace(R) - 1) / 2)
    np.testing.assert_allclose(angle, np.linalg.norm(rvec.numpy()), rtol=1e-2)


def test_oracle_icp_identity_on_same_frame():
    d = _t(render_scene_depth(np.eye(4)))
    icp = ticp.ProjectiveICP()
    icp.set_iterations([5, 3, 0, 0])
    T, ok = icp.estimate_transform_from_depth(INTR, d, d)
    assert ok
    np.testing.assert_allclose(T, np.eye(4), atol=1e-3)


def test_oracle_icp_recovers_small_translation():
    T1 = SCENES["translation"]
    icp = ticp.ProjectiveICP()
    icp.set_iterations([10, 5, 0, 0])
    Tinc, ok = icp.estimate_transform_from_depth(
        INTR, _t(render_scene_depth(T1)), _t(render_scene_depth(np.eye(4)))
    )
    assert ok
    # for a pure camera translation t the increment's translation approaches -t
    np.testing.assert_allclose(-Tinc[:3, 3], T1[:3, 3], atol=2e-3)


def test_used_levels_and_set_iterations():
    icp = ticp.ProjectiveICP()
    assert icp.iters == [10, 5, 4, 0] and icp.used_levels() == 3
    icp.set_iterations([4, 2])
    assert icp.iters == [4, 2, 0, 0] and icp.used_levels() == 2
    icp.set_iterations([1, 2, 3, 4, 5])
    assert icp.iters == [1, 2, 3, 4] and icp.used_levels() == 4
