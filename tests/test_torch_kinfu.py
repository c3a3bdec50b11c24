"""The rigid pipeline and the reference-API wrappers: sobfu_tpu_torch.kinfu,
models, reductor and scalar_fields against the JAX package on the CPU, and
the oracles of tests/test_components.py run on the port.

KinFu parity. The port corrects three steps of the JAX package's KinFu
(sobfu_tpu_torch/kinfu.py's docstring; ROADMAP Queue 3): the pose
composition, the map it integrates (depth along z, not ray lengths) and the
pixel a voxel reads (the nearest, not the floor). The tests below show each
of the three in the JAX package, then hold the port to JAX's KinFu with the
three corrected from outside (its ICP increment inverted, compute_dists
returning depth in metres, the principal point moved half a pixel for the
integration), on test_components.py's fixtures (48 x 64; 32^3 frame to
frame, 48^3 frame to model) over four frames of a camera moving 4 mm and
0.3 degrees a frame. Tolerances: poses within 1e-5 (measured 1.6e-7),
tsdf within 1e-5 (measured 2.4e-6) and the weights equal (measured: no
voxel's pixel flipped). Every pose after the first has a rotation, so both
packages take the integrator's general path from frame 1 on (checked).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sobfu_tpu.ops.imgproc as j_imgproc
from sobfu_tpu import fields as jf
from sobfu_tpu import solver as js
from sobfu_tpu.config import Intr as JIntr
from sobfu_tpu.config import translation_pose as j_pose
from sobfu_tpu.kinfu import KinFu as JKinFu
from sobfu_tpu.kinfu import KinFuParams as JKinFuParams
from sobfu_tpu.raycast import raycast_volume as j_raycast_volume
from sobfu_tpu.reductor import Reductor as JReductor
from sobfu_tpu.scalar_fields import ScalarField as JScalarField
from sobfu_tpu_torch import fields as tf
from sobfu_tpu_torch.config import Intr, translation_pose
from sobfu_tpu_torch.kinfu import KinFu, KinFuParams
from sobfu_tpu_torch.reductor import Reductor
from sobfu_tpu_torch.scalar_fields import ScalarField

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
from render_rigid_scene import render_depth, trajectory  # noqa: E402

torch.set_num_threads(1)

H, W = 48, 64
SCENES = {  # spheres in front of a wall, inside each fixture's volume
    "f2f": dict(spheres=[((0.0, 0.0, 0.8), 0.15), ((0.2, -0.12, 0.9), 0.07),
                         ((-0.22, 0.15, 0.85), 0.06)], wall_z=1.2),
    "f2m": dict(spheres=[((0.0, 0.0, 0.45), 0.1), ((0.1, -0.07, 0.5), 0.04),
                         ((-0.1, 0.08, 0.48), 0.035)], wall_z=0.7),
}
N_FRAMES = 4


def _params(cls, intr_cls, pose_fn, mode):
    """test_components.py's fixtures: 48 x 64, fx 60; frame to frame 32^3 of
    1.2 m, ICP (4, 2); frame to model 48^3 of 0.6 m, ICP (4,)."""
    p = cls.default_params()
    p.cols, p.rows = W, H
    p.intr = intr_cls(60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5)
    if mode == "f2m":
        p.volume_dims, p.volume_size = (48, 48, 48), (0.6, 0.6, 0.6)
        p.volume_pose = pose_fn((-0.3, -0.3, 0.25))
        p.tsdf_trunc_dist = 0.05
        p.icp_iter_num = (4, 0, 0, 0)
        p.track_against_model = True
    else:
        p.volume_dims, p.volume_size = (32, 32, 32), (1.2, 1.2, 1.2)
        p.volume_pose = pose_fn((-0.6, -0.6, 0.4))
        p.tsdf_trunc_dist = 0.15
        p.icp_iter_num = (4, 2, 0, 0)
    return p


def _frames(mode, step=0.004, yaw=0.3):
    poses = trajectory(N_FRAMES, step, yaw)
    return poses, [render_depth(T, H, W, (60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5), **SCENES[mode])
                   for T in poses]


def _jax_kinfu_corrected(p):
    """JAX's KinFu with the port's three corrections applied from outside
    (the caller also patches compute_dists; see the module docstring)."""
    kf = JKinFu(p)
    estimate, integrate = kf.icp_.estimate_transform, kf.volume_.integrate

    def inverted(*args):
        T, ok = estimate(*args)  # JAX composes pose @ inv(T): give it inv(T)
        return np.linalg.inv(T).astype(np.float32), ok

    def nearest_pixel(depth_m, pose, intr):
        return integrate(depth_m, pose, JIntr(intr.fx, intr.fy, intr.cx + 0.5, intr.cy + 0.5))

    kf.icp_.estimate_transform = inverted
    kf.volume_.integrate = nearest_pixel
    return kf


@pytest.fixture(scope="module", params=["f2f", "f2m"])
def kinfu_runs(request):
    """Both packages over the same frames: per frame (tracked, pose, tsdf,
    weight, whether the integration was axis-aligned) for each."""
    mode = request.param
    poses, frames = _frames(mode)
    jk = _jax_kinfu_corrected(_params(JKinFuParams, JIntr, j_pose, mode))
    tk = KinFu(_params(KinFuParams, Intr, translation_pose, mode), device="cpu")
    j_out, t_out = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_imgproc, "compute_dists", lambda d, intr: d.astype(jnp.float32) * 0.001)
        for d in frames:
            j_ok = jk(jnp.asarray(d))
            j_out.append((j_ok, jk.get_camera_pose().copy(), np.array(jk.tsdf().tsdf),
                          np.array(jk.tsdf().weight)))
            t_ok = tk(d)
            v2c = np.linalg.inv(tk.get_camera_pose()) @ tk.tsdf().pose
            t_out.append((t_ok, tk.get_camera_pose().copy(), tk.tsdf().tsdf.numpy().copy(),
                          tk.tsdf().weight.numpy().copy(),
                          bool(np.allclose(v2c[:3, :3], np.eye(3), atol=1e-6))))
    return mode, poses, j_out, t_out, tk


def test_kinfu_matches_corrected_jax(kinfu_runs):
    mode, poses, j_out, t_out, _ = kinfu_runs
    for k, ((j_ok, j_pose_k, j_tsdf, j_w), (t_ok, t_pose_k, t_tsdf, t_w, aligned)) in enumerate(
            zip(j_out, t_out)):
        assert t_ok is True and bool(j_ok) is True
        assert aligned == (k == 0), (k, aligned)  # frame 0 axis-aligned, then general
        assert t_pose_k.dtype == np.float32
        np.testing.assert_allclose(t_pose_k, j_pose_k, atol=1e-5, rtol=0)
        np.testing.assert_allclose(t_tsdf, j_tsdf, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(t_w, j_w)
    assert float(t_out[-1][3].sum()) > float(t_out[0][3].sum())  # later frames added weight


def test_kinfu_state_and_reset(kinfu_runs):
    """get_camera_pose's clamping, the pose history, reset."""
    mode, poses, _, t_out, tk = kinfu_runs
    assert tk.frame_counter_ == N_FRAMES and len(tk.poses_) == N_FRAMES
    np.testing.assert_array_equal(tk.get_camera_pose(0), np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(tk.get_camera_pose(), t_out[-1][1])
    np.testing.assert_array_equal(tk.get_camera_pose(N_FRAMES), t_out[-1][1])  # == len: last
    np.testing.assert_array_equal(tk.get_camera_pose(1), t_out[1][1])
    assert tk.tsdf().tsdf.device.type == "cpu" and tk.icp().used_levels() >= 1
    assert tk.params().track_against_model == (mode == "f2m")


def test_kinfu_reset_clears_the_state(capsys):
    p = _params(KinFuParams, Intr, translation_pose, "f2f")
    kf = KinFu(p, device="cpu")
    _, frames = _frames("f2f")
    assert kf(frames[0]) and kf(torch.from_numpy(frames[1].astype(np.int32)))
    assert float(kf.tsdf().weight.sum()) > 0
    kf.reset()
    assert "Reset" in capsys.readouterr().out
    assert kf.frame_counter_ == 0 and len(kf.poses_) == 1
    assert float(kf.tsdf().weight.abs().sum()) == 0.0
    assert kf._prev_points is None


def test_jax_kinfu_moves_the_camera_against_its_motion():
    """The first fault: the JAX package composes pose @ inv(Tinc), so a
    camera moving +x is tracked moving -x; the port follows the camera."""
    poses, frames = _frames("f2f", step=0.01, yaw=0.0)
    jk = JKinFu(_params(JKinFuParams, JIntr, j_pose, "f2f"))
    tk = KinFu(_params(KinFuParams, Intr, translation_pose, "f2f"), device="cpu")
    for d in frames:
        jk(jnp.asarray(d))
        tk(d)
    true_x = poses[-1][0, 3]
    assert jk.get_camera_pose()[0, 3] < -0.5 * true_x
    assert abs(tk.get_camera_pose()[0, 3] - true_x) < 0.2 * true_x


def test_jax_kinfu_integrates_ray_lengths_as_depth():
    """The second fault: JAX integrates compute_dists (depth * lambda)
    against the camera z of each voxel, so a raycast of one fused frame
    lies lambda - 1 behind the depth map off the optical axis (measured:
    the median 34.9 mm, 2.8 of the 12.5 mm voxels, and 58.8 mm where
    lambda > 1.07). The port's raycast lies on the depth map (measured
    5e-8 m at the median)."""
    _, frames = _frames("f2m")
    jk = JKinFu(_params(JKinFuParams, JIntr, j_pose, "f2m"))
    tk = KinFu(_params(KinFuParams, Intr, translation_pose, "f2m"), device="cpu")
    jk(jnp.asarray(frames[0]))
    tk(frames[0])
    z = frames[0].astype(np.float64) * 1e-3
    xl = (np.arange(W)[None, :] - (W / 2 - 0.5)) / 60.0
    yl = (np.arange(H)[:, None] - (H / 2 - 0.5)) / 60.0
    off_axis = xl * xl + yl * yl > 0.15  # lambda > 1.07
    errs = []
    for kf, raycast in ((jk, j_raycast_volume), (tk, None)):
        if raycast is None:
            from sobfu_tpu_torch.raycast import raycast_volume as raycast
        got = np.asarray(raycast(kf.tsdf(), np.eye(4, dtype=np.float32), kf.params().intr, H, W,
                                 0.5)[0])
        hit = got > 0
        errs.append((np.median(np.abs(got - z)[hit]), np.median(np.abs(got - z)[hit & off_axis])))
    vs = 0.6 / 48
    (j_med, j_off), (t_med, t_off) = errs
    assert j_off > 2 * vs and t_off < 0.3 * vs
    assert t_med < j_med


def test_nearest_pixel_integration_removes_the_half_pixel_drift():
    """The third fault: integrating with the floor pixel puts the fused
    surface half a pixel off the depth map, and frame-to-model tracking of a
    static camera drifts by it. The port's KinFu against the same KinFu
    integrating at the floor pixel (the JAX package's rule), four frames."""
    _, frames = _frames("f2m", step=0.0, yaw=0.0)
    drift = []
    for floor in (False, True):
        kf = KinFu(_params(KinFuParams, Intr, translation_pose, "f2m"), device="cpu")
        if floor:
            kf._integrate = lambda f, pose: kf.volume_.integrate(
                f.to(torch.float32) * 0.001, pose, kf.params().intr)
        for d in frames:
            assert kf(d)
        drift.append(float(np.linalg.norm(kf.get_camera_pose()[:3, 3])))
    assert drift[0] < 0.5 * drift[1], drift


def test_kinfu_on_the_card_by_default():
    """KinFu, like TsdfVolume and SobFusion, defaults to the card and raises
    without one: no CPU fallback."""
    if torch.cuda.is_available():
        assert KinFu(_params(KinFuParams, Intr, translation_pose, "f2f")).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="is_available"):
        KinFu(_params(KinFuParams, Intr, translation_pose, "f2f"))
    with pytest.raises(RuntimeError, match="is_available"):
        KinFu()


def test_kinfu_default_params_match_jax_and_reference():
    """KinFuParams: the JAX package's fields and defaults (reference
    kinfu.cpp:10-44)."""
    import dataclasses

    a, b = KinFuParams.default_params(), JKinFuParams.default_params()
    names = [f.name for f in dataclasses.fields(JKinFuParams)]
    assert [f.name for f in dataclasses.fields(KinFuParams)] == names
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(a, n)), np.asarray(getattr(b, n)), n)
    assert (a.cols, a.rows) == (640, 480)
    np.testing.assert_allclose(list(a.intr), [525.0, 525.0, 319.5, 239.5])
    assert a.volume_dims == (512, 512, 512) and a.volume_size == (3.0, 3.0, 3.0)
    assert a.icp_iter_num == (10, 5, 4, 0)
    np.testing.assert_allclose(a.tsdf_trunc_dist, 0.04)


def test_models_exports():
    import sobfu_tpu_torch
    from sobfu_tpu_torch import models
    from sobfu_tpu_torch.pipeline import SobFusion

    assert models.__all__ == ["SobFusion", "KinFu", "KinFuParams"]
    assert models.KinFu is KinFu and models.KinFuParams is KinFuParams
    assert models.SobFusion is SobFusion
    for name in ("ScalarField", "Reductor", "KinFu", "KinFuParams", "icp", "models", "raycast"):
        assert name in sobfu_tpu_torch.__all__ and hasattr(sobfu_tpu_torch, name)


# ---------------------------------------------------------------------------
# tests/test_components.py's KinFu oracles, on the port
# ---------------------------------------------------------------------------


def _synthetic_depth(z_mm=800):
    """Flat wall at z_mm with a centred square bump (test_components.py)."""
    d = np.full((H, W), z_mm, np.uint16)
    d[H // 4: 3 * H // 4, W // 4: 3 * W // 4] = z_mm - 150
    return d


def test_oracle_kinfu_tracks_static_scene():
    kf = KinFu(_params(KinFuParams, Intr, translation_pose, "f2f"), device="cpu")
    depth = _synthetic_depth()
    assert kf(depth)
    assert kf(depth)  # identical frame -> ~identity increment
    pose = kf.get_camera_pose()
    np.testing.assert_allclose(pose[:3, 3], 0.0, atol=5e-3)
    np.testing.assert_allclose(pose[:3, :3], np.eye(3), atol=5e-3)
    assert kf.frame_counter_ == 2
    assert float(kf.tsdf().weight.sum()) > 0
    kf.reset()
    assert kf.frame_counter_ == 0
    assert float(kf.tsdf().weight.sum()) == 0.0


def test_oracle_kinfu_frame_to_model_tracking():
    from tests.test_pipeline import render_sphere_depth

    kf = KinFu(_params(KinFuParams, Intr, translation_pose, "f2m"), device="cpu")
    depth = render_sphere_depth((0.0, 0.0, 0.45), 0.12)
    assert kf(depth)
    assert kf(depth)
    pose = kf.get_camera_pose()
    assert np.linalg.norm(pose[:3, 3]) < 0.02, pose[:3, 3]
    np.testing.assert_allclose(pose[:3, :3], np.eye(3), atol=0.03)


# ---------------------------------------------------------------------------
# Reductor and ScalarField
# ---------------------------------------------------------------------------


def _reductor_inputs(n=8, seed=0):
    rng = np.random.default_rng(seed)
    tg = rng.standard_normal((n, n, n)).astype(np.float32)
    tnp = rng.standard_normal((n, n, n)).astype(np.float32)
    ident = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij")[::-1]).astype(np.float32)
    psi = ident + 0.1 * rng.standard_normal((3, n, n, n)).astype(np.float32)
    return tg, tnp, psi


def test_reductor_matches_jax():
    """Energies within rtol 1e-6 (sums in another order), the max norm and
    the voxel max energy with the same flat index; each returns Python
    floats and ints."""
    tg, tnp, psi = _reductor_inputs()
    j, t = JReductor((8, 8, 8)), Reductor((8, 8, 8))
    T = torch.from_numpy
    got, want = t.data_energy(T(tg), T(tnp)), j.data_energy(jnp.asarray(tg), jnp.asarray(tnp))
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(t.reg_energy_sobolev(T(psi)), j.reg_energy_sobolev(jnp.asarray(psi)),
                               rtol=1e-6)
    upd = psi - np.round(psi)
    (gn, gi), (wn, wi) = t.max_update_norm(T(upd)), j.max_update_norm(jnp.asarray(upd))
    assert isinstance(gn, float) and isinstance(gi, int) and gi == wi
    np.testing.assert_allclose(gn, wn, rtol=1e-6)
    (ge, gi), (we, wi) = (t.voxel_max_energy(T(tg), T(tnp), T(psi), 0.3),
                          j.voxel_max_energy(jnp.asarray(tg), jnp.asarray(tnp), jnp.asarray(psi),
                                             0.3))
    assert isinstance(ge, float) and isinstance(gi, int) and gi == wi
    np.testing.assert_allclose(ge, we, rtol=1e-6)


def test_scalar_field_matches_jax():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((6, 5, 4)).astype(np.float32)
    j, t = JScalarField((4, 5, 6), jnp.asarray(data)), ScalarField((4, 5, 6), torch.from_numpy(data))
    got = t.sum()
    assert isinstance(got, float)
    np.testing.assert_allclose(got, j.sum(), rtol=1e-6)
    t.clear()
    assert t.sum() == 0.0 and tuple(t.data.shape) == (6, 5, 4)
    assert tuple(ScalarField((4, 5, 6), device="cpu").data.shape) == (6, 5, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            ScalarField((4, 5, 6))


def test_oracle_scalar_field_sum(capsys):
    f = ScalarField((8, 8, 8), device="cpu")
    assert f.sum() == 0.0
    f.data = torch.ones((8, 8, 8))
    np.testing.assert_allclose(f.sum(), 512.0)
    f.print()
    assert "1." in capsys.readouterr().out
    f.clear()
    assert f.sum() == 0.0


def test_oracle_reductor_energies_match_solver():
    from sobfu_tpu_torch import solver as ts

    tg, tnp, psi = _reductor_inputs()
    r = Reductor((8, 8, 8))
    T = torch.from_numpy
    np.testing.assert_allclose(r.data_energy(T(tg), T(tnp)),
                               float(ts.data_energy(T(tg), T(tnp))), rtol=1e-6)
    np.testing.assert_allclose(r.reg_energy_sobolev(T(psi)),
                               float(ts.reg_energy_sobolev(T(psi))), rtol=1e-6)
    # and the JAX package's solver functions, the oracles' own reference
    np.testing.assert_allclose(r.data_energy(T(tg), T(tnp)),
                               float(js.data_energy(jnp.asarray(tg), jnp.asarray(tnp))), rtol=1e-6)


def test_oracle_reductor_max_update_norm_argmax():
    n = 8
    updates = torch.zeros((3, n, n, n))
    updates[:, 2, 3, 4] = torch.tensor([3.0, 4.0, 0.0])
    norm, idx = Reductor((n, n, n)).max_update_norm(updates)
    np.testing.assert_allclose(norm, 5.0, rtol=1e-6)
    assert idx == (2 * n + 3) * n + 4


def test_oracle_reductor_voxel_max_energy_pure_data_term():
    n = 8
    tg = torch.zeros((n, n, n))
    tnp = torch.zeros((n, n, n))
    tnp[1, 2, 3] = 2.0
    e, idx = Reductor((n, n, n)).voxel_max_energy(tg, tnp, tf.identity_field((n, n, n)), w_reg=0.5)
    np.testing.assert_allclose(e, 0.5 * 4.0, rtol=1e-6)
    assert idx == (1 * n + 2) * n + 3
    # the same through the JAX package's identity field
    assert JReductor((n, n, n)).voxel_max_energy(
        jnp.asarray(tg.numpy()), jnp.asarray(tnp.numpy()), jf.identity_field((n, n, n)), 0.5
    )[1] == idx
