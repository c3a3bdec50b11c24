"""The slice as a whole: sobfu_tpu_torch.SobFusion against sobfu_tpu.SobFusion.

Both packages run the same 4-frame sequence at 32^3 on the CPU: a sphere
translating in x, rendered in memory by tools/make_synthetic_scene's
render_prims_depth (numpy). Frame 0 integrates, frames 1-3 solve
(START_FRAME=1, MAX_ITER=16) and fuse. Tolerances: volumes and fields at
atol 1e-5 (a few ulps per iteration, as the goldens allow); weights and
iteration counts exactly; meshes with the same triangle count and
vertices within 1e-5 m.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import config as jc
from sobfu_tpu import pipeline as jp
from sobfu_tpu_torch import config as tc
from sobfu_tpu_torch import pipeline as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_synthetic_scene  # noqa: E402

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

H, W = 48, 64
DIM = 32


def _params(cfg, warp_window, **extra):
    p = cfg.Params()
    p.volume_dims = (DIM, DIM, DIM)
    p.volume_size = (0.4, 0.4, 0.4)
    p.volume_pose = cfg.translation_pose((-0.2, -0.2, 0.25))
    p.intr = cfg.Intr(60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5)
    vs = 0.4 / DIM
    p.tsdf_trunc_dist = 6.0 * vs
    p.eta = 3.0 * vs
    p.bilateral_kernel_size = 5
    p.start_frame = 1
    p.max_iter = 16
    p.max_update_norm = 1e-6
    p.alpha = 0.1
    p.w_reg = 0.2
    p.warp_window = warp_window
    for k, v in extra.items():
        setattr(p, k, v)
    return p


def _frames():
    intr = (60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5)
    return [
        make_synthetic_scene.render_prims_depth(H, W, *intr, [((0.005 * i, 0.0, 0.45), 0.08)])
        for i in range(4)
    ]


# (WARP_WINDOW, need_inv_warps, extra params): the window slice in the
# no-log loop and with the per-frame inverse warps, the exact mode, and the
# window slice with a rigid warm-up frame (START_FRAME=2) and the
# surface-confidence gate. The exact mode is pinned to need_inv_warps=True:
# in the no-log loop the JAX package floor-warps weight_n with a K=2 window
# even without WARP_WINDOW (see test_exact_mode_weight_warp_divergence).
CONFIGS = [
    (2, False, {}),
    (2, True, {}),
    (None, True, {}),
    (2, False, {"start_frame": 2, "new_surface_gate": 1.5}),
]


@pytest.fixture(
    scope="module", params=CONFIGS, ids=["window-nolog", "window-log", "exact-log", "rigid-gate"]
)
def runs(request):
    ww, need_inv, extra = request.param
    frames = _frames()
    fj = jp.SobFusion(_params(jc, ww, **extra))
    fj.need_inv_warps = need_inv
    ft = tp.SobFusion(_params(tc, ww, **extra), device="cpu")
    ft.need_inv_warps = need_inv
    for d in frames:
        fj(jnp.asarray(d))
        ft(d)
    return fj, ft


def test_canonical_volume_matches(runs):
    fj, ft = runs
    np.testing.assert_allclose(ft.phi_global.tsdf.numpy(), np.asarray(fj.phi_global.tsdf),
                               atol=1e-5)
    np.testing.assert_array_equal(ft.phi_global.weight.numpy(),
                                  np.asarray(fj.phi_global.weight))
    assert float(ft.phi_global.weight.sum()) > 0


def test_fields_and_iterations_match(runs):
    fj, ft = runs
    np.testing.assert_allclose(ft.psi.data.numpy(), np.asarray(fj.psi.data), atol=1e-5)
    np.testing.assert_allclose(ft.psi_inv.data.numpy(), np.asarray(fj.psi_inv.data),
                               atol=1e-5)
    assert ft.last_solve.iters == int(fj.last_solve.iters) == 16
    assert ft.solver.inverse_iters == fj.solver.inverse_iters
    np.testing.assert_allclose(ft.last_solve.max_norm, float(fj.last_solve.max_norm),
                               rtol=1e-4)
    assert ft.frame_counter == fj.frame_counter == 4


def test_live_volumes_match(runs):
    """phi_n, phi_n o psi (refreshed on demand in the no-log loop) and
    phi_global o psi_inv (refreshed from the current canonical there)."""
    fj, ft = runs
    np.testing.assert_array_equal(ft.phi_n.weight.numpy(), np.asarray(fj.phi_n.weight))
    mj, mt = fj.get_phi_n_psi_mesh(), ft.get_phi_n_psi_mesh()
    np.testing.assert_allclose(ft.phi_n_psi.tsdf.numpy(), np.asarray(fj.phi_n_psi.tsdf),
                               atol=1e-5)
    np.testing.assert_array_equal(ft.phi_n_psi.weight.numpy(),
                                  np.asarray(fj.phi_n_psi.weight))
    assert mj.n_triangles == mt.n_triangles
    fj.get_phi_global_psi_inv_mesh()
    ft.get_phi_global_psi_inv_mesh()
    np.testing.assert_allclose(ft.phi_global_psi_inv.tsdf.numpy(),
                               np.asarray(fj.phi_global_psi_inv.tsdf), atol=1e-5)


def test_extract_mesh_matches(runs):
    fj, ft = runs
    mj, mt = fj.get_phi_global_mesh(), ft.get_phi_global_mesh()
    assert mt.n_triangles == mj.n_triangles > 50
    np.testing.assert_allclose(mt.vertices, mj.vertices, atol=1e-5)
    np.testing.assert_allclose(mt.normals, mj.normals, atol=1e-3)


def test_staged_verbose_path_matches_fused(capsys):
    """verbosity > 0 runs the staged path (Solver.estimate_psi with energy
    prints, then integrate_volume); it lands on the fused path's state."""
    frames = _frames()[:3]
    out = []
    for verbosity in (0, 1):
        f = tp.SobFusion(_params(tc, 2, verbosity=verbosity), device="cpu")
        for d in frames:
            f(d)
        out.append(f)
    assert "SOLVER REACHED MAX. NO. OF ITERATIONS" in capsys.readouterr().out
    np.testing.assert_allclose(out[1].phi_global.tsdf.numpy(), out[0].phi_global.tsdf.numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(out[1].psi.data.numpy(), out[0].psi.data.numpy())


def test_exact_mode_weight_warp_divergence():
    """Recorded divergence: in its no-log loop the JAX package floor-warps
    weight_n with a K=2 window even when WARP_WINDOW is unset
    (sobfu_tpu/pipeline.py:231). The port applies the exact rule. Where a
    displacement exceeds 2 voxels the two pick different voxels."""
    import sobfu_tpu.fields as jf
    from sobfu_tpu.tsdf import fuse_volumes as j_fuse
    from sobfu_tpu_torch.ops import kernels

    dims = (8, 8, 8)
    rng = np.random.default_rng(0)
    wn = rng.integers(0, 2, dims).astype(np.float32)
    tg = rng.standard_normal(dims).astype(np.float32)
    wg = np.ones(dims, np.float32)
    tnp = rng.standard_normal(dims).astype(np.float32)
    ident = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")[::-1])
    psi = (ident + np.array([3.4, 0.0, 0.0])[:, None, None, None]).astype(np.float32)
    T = torch.from_numpy
    port = kernels.warp_fuse(T(tg), T(wg), T(tnp), T(wn), T(psi), 64.0, None)
    exact = j_fuse(jnp.asarray(tg), jnp.asarray(wg), jnp.asarray(tnp),
                   jf.sample_nearest_floor(jnp.asarray(wn), jnp.asarray(psi)), 64.0)
    jax_nolog = j_fuse(jnp.asarray(tg), jnp.asarray(wg), jnp.asarray(tnp),
                       jf.sample_nearest_floor_window(jnp.asarray(wn), jnp.asarray(psi), 2),
                       64.0)
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(exact[1]))
    assert not np.array_equal(np.asarray(exact[1]), np.asarray(jax_nolog[1]))


def test_cli_writes_meshes(tmp_path):
    """python -m sobfu_tpu_torch <scene> <ini> --device cpu --enable-log on
    a tiny scene written by tools/make_synthetic_scene.py."""
    from sobfu_tpu_torch import cli

    scene = tmp_path / "scene"
    make_synthetic_scene.main([str(scene), "--frames", "3", "--dim", "24", "--width", "64",
                               "--height", "48"])
    ini = scene / "params.ini"
    ini.write_text(ini.read_text() + "MAX_ITER=8\n")
    assert cli.main([str(scene), str(ini), "--device", "cpu", "--enable-log"]) == 0
    meshes = sorted(os.listdir(scene / "meshes"))
    assert meshes == ["mesh_0001.vtk", "mesh_0002.vtk"]
    text = (scene / "meshes" / meshes[-1]).read_text()
    assert "POLYGONS" in text and int(text.split("POINTS ")[1].split()[0]) > 0
    assert sorted(os.listdir(scene / "fields")) == ["psi_0001.vti", "psi_0002.vti"]


# the production solver keys at 32^3: PYRAMID_LEVELS=2, momentum 0.95 with
# ALPHA 0.05, the stall stop, MAX_UPDATE_NORM 4e-3. INV_MULTIGRID=0 keeps
# JAX on the CPU on the branch the port takes (its multigrid inverse runs
# only inside its Pallas dispatch).
PYRAMID_KEYS = dict(pyramid_levels=2, momentum=0.95, alpha=0.05, max_iter=64,
                    max_update_norm=4e-3, stall_window=16, stall_rel=1e-2,
                    inv_multigrid=False)


@pytest.fixture(scope="module")
def pyramid_runs():
    frames = _frames()
    fj = jp.SobFusion(_params(jc, 2, **PYRAMID_KEYS))
    fj.need_inv_warps = False
    ft = tp.SobFusion(_params(tc, 2, **PYRAMID_KEYS), device="cpu")
    ft.need_inv_warps = False
    iters = []
    for d in frames:
        fj(jnp.asarray(d))
        ft(d)
        if ft.last_solve is not None:
            iters.append((ft.last_solve.iters, ft.last_solve.coarse_iters,
                          int(fj.last_solve.iters)))
    return fj, ft, iters


def test_pyramid_frames_match_jax(pyramid_runs):
    """Every solve frame ends on the same iteration count, and the
    canonical volume agrees at atol 1e-5 (weights exactly). psi and psi_inv
    are held at atol 2e-5: their coordinates reach 31 voxels (1e-5 is 5 ulps
    there), the resample contractions add their taps in another order than
    XLA's dot (an ulp), and 112 heavy-ball iterations per frame at momentum
    0.95 over three frames amplify that to 1.3e-5."""
    fj, ft, iters = pyramid_runs
    assert len(iters) == 3
    for port_iters, coarse, jax_iters in iters:
        assert port_iters == jax_iters and 0 < coarse < port_iters
    np.testing.assert_allclose(ft.phi_global.tsdf.numpy(), np.asarray(fj.phi_global.tsdf),
                               atol=1e-5)
    np.testing.assert_array_equal(ft.phi_global.weight.numpy(),
                                  np.asarray(fj.phi_global.weight))
    np.testing.assert_allclose(ft.psi.data.numpy(), np.asarray(fj.psi.data), atol=2e-5)
    np.testing.assert_allclose(ft.psi_inv.data.numpy(), np.asarray(fj.psi_inv.data),
                               atol=2e-5)


def test_pyramid_meshes_match_jax(pyramid_runs):
    fj, ft, _ = pyramid_runs
    mj, mt = fj.get_phi_global_mesh(), ft.get_phi_global_mesh()
    assert mt.n_triangles == mj.n_triangles > 50
    np.testing.assert_allclose(mt.vertices, mj.vertices, atol=1e-5)
    fj.get_phi_global_psi_inv_mesh()
    ft.get_phi_global_psi_inv_mesh()
    np.testing.assert_allclose(ft.phi_global_psi_inv.tsdf.numpy(),
                               np.asarray(fj.phi_global_psi_inv.tsdf), atol=1e-5)


def test_coarse_inverse_carry():
    """The no-log loop with the multigrid inverse and INV_COARSE: psi_inv is
    allocated and carried at half resolution; the psi_inv mesh getter
    materialises the full-resolution inverse (upsample + one anchoring
    step, held to the same composition of JAX's plain pieces) and leaves
    the carry half-res."""
    import sobfu_tpu.fields as jf
    from sobfu_tpu import solver as js

    frames = _frames()
    p = _params(tc, 2, fused_pallas=True, inv_coarse=True, **PYRAMID_KEYS)
    p.inv_multigrid = None  # auto: on with the fused dispatch and a pyramid
    ft = tp.SobFusion(p, device="cpu")
    ft.need_inv_warps = False
    ft(frames[0])
    assert ft.solver.inv_multigrid and ft.solver.inv_coarse
    half = (3, DIM // 2, DIM // 2, DIM // 2)
    assert tuple(ft.psi_inv.data.shape) == half
    for d in frames[1:3]:
        ft(d)
        assert tuple(ft.psi_inv.data.shape) == half
    assert ft._inv_warps_stale
    inv_c = jnp.asarray(ft.psi_inv.data.numpy())
    ft.get_phi_global_psi_inv_mesh()
    assert tuple(ft.psi_inv.data.shape) == half
    dims = (DIM,) * 3
    full = ft.full_res_inverse()
    assert tuple(full.shape) == (3,) + dims
    q0 = jf.identity_field(dims) + js._resample_disp(
        inv_c - jf.identity_field(inv_c.shape[1:]), dims, 2.0)
    want_inv = jf.estimate_inverse_window(jnp.asarray(ft.psi.data.numpy()), 1, 2, init=q0)
    np.testing.assert_allclose(full.numpy(), np.asarray(want_inv), atol=1e-5)
    want_tsdf = jf.sample_trilinear_window(jnp.asarray(ft.phi_global.tsdf.numpy()),
                                           want_inv, 2)
    assert ft.phi_global_psi_inv.tsdf.shape == ft.phi_global.tsdf.shape
    np.testing.assert_allclose(ft.phi_global_psi_inv.tsdf.numpy(), np.asarray(want_tsdf),
                               atol=1e-5)
