"""TSDF raycasting: sobfu_tpu_torch.raycast against sobfu_tpu.raycast on
the CPU, on tests/test_raycast.py's 64^3 sphere, and that file's analytic
oracles run on the port.

The parity runs march 160 steps (0.5 voxel each: the rays reach the
sphere's far side, 0.5 m, and stop short of the volume's back) instead of
512, to keep JAX's scan compile and the port's loop short. Tolerances: the
same hit mask; depth and points within 1e-5 (measured 3.6e-7: the step's
position and the crossing's refinement round alike, the rotation of the
rays is a matmul summed in another order); normals within 1e-5 (measured
4.4e-6: the gradient is a difference of trilinear samples, normalised).
"""

import numpy as np
import pytest
import torch

from sobfu_tpu.raycast import raycast_volume as j_raycast_volume
from sobfu_tpu_torch import tsdf as tt
from sobfu_tpu_torch.config import Intr, Params, translation_pose
from sobfu_tpu_torch.raycast import raycast, raycast_volume
from tests.test_raycast import INTR as J_INTR
from tests.test_raycast import H, W, _sphere_volume

torch.set_num_threads(1)

INTR = Intr(*J_INTR)
STEPS = 160


def _port_volume(jax_volume=None):
    """The same volume in the port (on the CPU); with jax_volume, its arrays."""
    p = Params()
    p.volume_dims = (64, 64, 64)
    p.volume_size = (0.4, 0.4, 0.4)
    p.volume_pose = translation_pose((-0.2, -0.2, 0.25))
    p.tsdf_trunc_dist = 8.0 * 0.4 / 64
    p.eta = 4.0 * 0.4 / 64
    vol = tt.TsdfVolume(p, device="cpu")
    if jax_volume is None:
        vol.init_sphere((0.2, 0.2, 0.2), 0.08)
    else:
        vol.tsdf = torch.from_numpy(np.array(jax_volume.tsdf))
        vol.weight = torch.from_numpy(np.array(jax_volume.weight))
    return vol


def _pose(rot_y, t):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(rot_y), np.sin(rot_y)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[:3, 3] = t
    return T


@pytest.fixture(scope="module")
def volumes():
    jv = _sphere_volume()
    return jv, _port_volume(jv)


@pytest.mark.parametrize("pose", [np.eye(4, dtype=np.float32), _pose(0.05, (0.01, -0.005, 0.0)),
                                  _pose(-0.08, (-0.02, 0.01, 0.02))])
def test_raycast_volume_matches_jax(volumes, pose):
    jv, tv = volumes
    jd, jp, jn = j_raycast_volume(jv, pose, J_INTR, H, W, step_factor=0.5, max_steps=STEPS)
    td, tp, tn = raycast_volume(tv, pose, INTR, H, W, step_factor=0.5, max_steps=STEPS)
    jd = np.asarray(jd)
    assert (jd > 0).sum() > 300
    np.testing.assert_array_equal(td.numpy() > 0, jd > 0)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5, rtol=0)


def test_raycast_shapes_and_misses():
    """raycast itself: [H, W] and [H, W, 3] maps, zeros where the rays miss
    (rays that start outside the volume and never enter it)."""
    vol = _port_volume()
    cam2vol = np.linalg.inv(vol.pose) @ np.eye(4, dtype=np.float32)
    d, p, n = raycast(vol.tsdf, vol.weight, cam2vol, INTR, vol.voxel_sizes(), 12, 16,
                      0.5 * 0.4 / 64, max_steps=8)
    assert tuple(d.shape) == (12, 16) and tuple(p.shape) == (12, 16, 3)
    assert tuple(n.shape) == (12, 16, 3)
    assert float(d.abs().sum() + p.abs().sum() + n.abs().sum()) == 0.0  # 8 steps end at 0.025 m


# ---------------------------------------------------------------------------
# tests/test_raycast.py's analytic oracles, on the port (all 512 steps)
# ---------------------------------------------------------------------------


def test_oracle_raycast_sphere_depth_matches_analytic():
    vol = _port_volume()
    depth, points, normals = raycast_volume(vol, np.eye(4), INTR, H, W, step_factor=0.5)
    depth = depth.numpy()
    cy, cx = H // 2, W // 2
    # central ray hits the near surface of the sphere: z = 0.45 - 0.08
    assert abs(depth[cy, cx] - 0.37) < 0.01, depth[cy, cx]
    assert depth[0, 0] == 0.0  # off-object rays miss
    hits = depth > 0
    assert 50 < hits.sum() < H * W / 2
    # normals on the camera-facing cap point toward the camera (-z)
    assert normals.numpy()[cy, cx, 2] < -0.9
    np.testing.assert_allclose(points.numpy()[cy, cx, 2], depth[cy, cx], rtol=1e-5)


def test_oracle_raycast_respects_weight_gating():
    vol = _port_volume()
    vol.weight = torch.zeros_like(vol.weight)  # nothing observed
    depth, _, _ = raycast_volume(vol, np.eye(4), INTR, H, W)
    assert float(depth.sum()) == 0.0
