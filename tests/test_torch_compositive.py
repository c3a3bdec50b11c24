"""The port's compositive mode against sobfu_tpu on the CPU.

Kernel F's and B-on-three-channels' plain versions against the JAX
package's interpret-mode Pallas kernels and its XLA window samplers (the
inputs of tests/test_pallas.py); ``estimate_psi_compositive`` against its
frozen golden and against JAX's XLA path at 16^3 (the increment pyramid,
momentum, the stall stop, the incremental inverse); the compositive fine
level of ``estimate_psi_pyramid``; and SobFusion over 4 frames at 32^3 in
compositive mode and with FINE_WINDOW.

On the CPU JAX runs only the exact (unfused) branch, so the whole-solve
parity runs the port unfused too; the fused branch (the window-K
composition) is held to the exact one where the increment stays inside
the window. Tolerances: psi and psi_inv at atol 2e-5 for one solve — the
port's loop keeps the absolute state id + delta where JAX keeps delta, so
every iteration rounds at coordinates up to 31 (1e-5 is 5 ulps there) —
and 3e-5 after three frames (FIELD_ATOL); volumes at atol 1e-5, weights
and iteration counts exactly.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import config as jc
from sobfu_tpu import fields as jf
from sobfu_tpu import pipeline as jp
from sobfu_tpu import solver as js
from sobfu_tpu.ops.pallas_kernels import compose_weight_pallas, window_warp_field3_pallas
from sobfu_tpu.tsdf import init_sphere as j_init_sphere
from sobfu_tpu_torch import config as tc
from sobfu_tpu_torch import fields as tf
from sobfu_tpu_torch import pipeline as tp
from sobfu_tpu_torch import solver as ts
from sobfu_tpu_torch.ops import kernels
from sobfu_tpu_torch.tsdf import init_sphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_synthetic_scene  # noqa: E402

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
F32 = np.float32


def _ident(dims):
    return np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")[::-1]).astype(F32)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# the two kernels' plain versions
# ---------------------------------------------------------------------------


def _compose_inputs(Kf):
    """tests/test_pallas.py:473-486: psi0 within 0.95 of the identity, the
    increment within Kf - 0.05, weights 0/1."""
    dims = (16, 16, 64)
    rng = np.random.default_rng(11)
    ident = _ident(dims)
    field = ident + rng.uniform(-0.95, 0.95, (3,) + dims).astype(F32)
    pos = ident + rng.uniform(-(Kf - 0.05), Kf - 0.05, (3,) + dims).astype(F32)
    weight = (rng.uniform(0, 1, dims) > 0.4).astype(F32)
    return field, pos, weight


@pytest.mark.parametrize("Kf,Kw", [(1, 2), (2, 2)])
def test_compose_weight_plain_matches_jax(Kf, Kw):
    """F's plain version against compose_weight_pallas in interpret mode
    (psi atol 1e-4, the bound of JAX's own test; weights equal) and against
    the two XLA window samplers it fuses (psi atol 2e-5: coordinates reach
    63, where an ulp is 7.6e-6, and XLA may contract the blend; weights
    equal). With Kf=2 psi_new leaves the Kw=2 window: both clamp."""
    field, pos, weight = _compose_inputs(Kf)
    T = torch.from_numpy
    psi_new, wnp = kernels.compose_weight(T(field), T(pos), T(weight), Kf, Kw)
    j = jnp.asarray
    pl_psi, pl_w = compose_weight_pallas(j(field), j(pos), j(weight), Kf=Kf, Kw=Kw,
                                         interpret=True)
    np.testing.assert_allclose(_np(psi_new), _np(pl_psi), atol=1e-4)
    np.testing.assert_array_equal(_np(wnp), _np(pl_w))
    x_psi = jf.sample_trilinear_window(j(field), j(pos), max_disp=Kf)
    x_w = jf.sample_nearest_floor_window(j(weight), x_psi, max_disp=Kw)
    np.testing.assert_allclose(_np(psi_new), _np(x_psi), atol=2e-5)
    np.testing.assert_array_equal(_np(wnp), _np(x_w))


def _field3_inputs():
    """tests/test_pallas.py:444-461 in its rng order: the field, positions
    inside the K=1 and K=2 windows, and positions up to 3 voxels away."""
    dims = (16, 16, 64)
    rng = np.random.default_rng(7)
    ident = _ident(dims)
    field = ident + rng.uniform(-2.0, 2.0, (3,) + dims).astype(F32)
    pos = {K: ident + rng.uniform(-(K - 0.05), K - 0.05, (3,) + dims).astype(F32)
           for K in (1, 2)}
    pos["big"] = ident + rng.uniform(-3.0, 3.0, (3,) + dims).astype(F32)
    return field, pos


@pytest.mark.parametrize("case,K", [(1, 1), (2, 2), ("big", 1)],
                         ids=["in-window-1", "in-window-2", "beyond-window-1"])
def test_warp_field3_plain_matches_jax(case, K):
    """B-on-three-channels' plain version against window_warp_field3_pallas in
    interpret mode (atol 1e-4, JAX's bound) and the XLA window sampler
    (atol 2e-5, 3 ulps at coordinates up to 63); beyond the window both
    clamp the same way."""
    field, pos = _field3_inputs()
    got = kernels.warp_field3(torch.from_numpy(field), torch.from_numpy(pos[case]), K)
    pl = window_warp_field3_pallas(jnp.asarray(field), jnp.asarray(pos[case]), K=K,
                                   interpret=True)
    np.testing.assert_allclose(_np(got), _np(pl), atol=1e-4)
    xla = jf.sample_trilinear_window(jnp.asarray(field), jnp.asarray(pos[case]), max_disp=K)
    np.testing.assert_allclose(_np(got), _np(xla), atol=2e-5)


def test_warp_field3_exact_plain_matches_jax():
    """K None: the exact field sample (the unfused composition and the
    incremental inverse's sample of dq at psi_inv0), atol 2e-5."""
    field, pos = _field3_inputs()
    got = kernels.warp_field3(torch.from_numpy(field), torch.from_numpy(pos["big"]), None)
    want = jf.sample_field_trilinear(jnp.asarray(field), jnp.asarray(pos["big"]))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


def test_compositive_wrappers_launch_no_kernel_on_cpu():
    field, pos = _field3_inputs()
    kernels.reset_launch_counts()
    T = torch.from_numpy
    kernels.warp_field3(T(field), T(pos[1]), 1)
    kernels.compose_weight(T(field), T(pos[1]), T(field[0].copy()), 1, 2)
    assert kernels.launch_counts == {k: 0 for k in kernels.launch_counts}
    with pytest.raises(ValueError, match="3-channel"):
        kernels.warp_field3(T(field[:2].copy()), T(pos[1]), 1)
    with pytest.raises(ValueError, match="windows"):
        kernels.compose_weight(T(field), T(pos[1]), T(field[0].copy()), None, 2)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

DIMS = (16, 16, 16)
VS = 0.25 / 16


def test_compositive_matches_golden():
    """tests/golden/solver_16_compositive.npz (warp_window=2, 8 inverse steps,
    the exact branch, a cold inverse) at its atol 1e-5."""
    tg, wg = init_sphere(DIMS, (VS,) * 3, (0.125,) * 3, 0.04, 8 * VS, 3 * VS)
    tn, wn = init_sphere(DIMS, (VS,) * 3, (0.118, 0.125, 0.125), 0.04, 8 * VS, 3 * VS)
    res = ts.estimate_psi_compositive(tf.identity_field(DIMS), tg, wg, tn, wn,
                                      ts.sobolev_filter_1d(7, 0.1), 0.1, 0.3, 32, -1.0,
                                      warp_window=2, inverse_iters=8)
    g = np.load(os.path.join(GOLDEN_DIR, "solver_16_compositive.npz"))
    np.testing.assert_allclose(res.psi.numpy(), g["psi"], atol=1e-5)
    np.testing.assert_allclose(res.tsdf_n_psi.numpy(), g["tnp"], atol=1e-5)
    np.testing.assert_allclose(res.psi_inv.numpy(), g["psi_inv"], atol=1e-5)
    # the last update is ~1e-3 voxel, and the absolute state rounds at 1.9e-6
    # (an ulp at 16) each iteration where JAX's delta state does not: rtol 1e-3
    np.testing.assert_allclose(res.max_norm, float(g["max_norm"]), rtol=1e-3)
    assert res.iters == 32


def _disp0(amp_x, amp_s):
    """A smooth accumulated displacement: amp_x voxels in x plus a sine of
    amplitude amp_s along z."""
    z = np.arange(DIMS[0], dtype=F32)[:, None, None]
    d = np.zeros((3,) + DIMS, F32)
    d[0] = amp_x + amp_s * np.sin(2 * np.pi * z / DIMS[0])
    d[1] = 0.5 * amp_s * np.cos(2 * np.pi * z / DIMS[0])
    return d


def _scene(centre_x, disp0):
    """numpy inputs: tg, wg (sphere at the centre), tn, wn (moved to
    centre_x), psi0 = id + disp0 and psi_inv0 = id - disp0."""
    out = {}
    for key, cx in (("g", 0.125), ("n", centre_x)):
        t, w = j_init_sphere(DIMS, (VS,) * 3, (cx, 0.125, 0.125), 0.04, 8 * VS, 3 * VS)
        out["t" + key], out["w" + key] = np.array(t), np.array(w)
    ident = _ident(DIMS)
    out["psi0"], out["psi_inv0"] = ident + disp0, ident - disp0
    return out


# (psi_inv0 given, skip_inv_warps): the incremental inverse, the cold exact
# inverse, and the no-log loop's skipped inverse and tails
SOLVE_CASES = {"incremental": (True, False), "cold": (False, False),
               "skip-inverse": (True, True)}
SOLVE_KW = dict(warp_window=2, momentum=0.9, stall_window=16, stall_rel=1e-2,
                pyramid_levels=2, inverse_iters=6)
SOLVE_ARGS = (0.05, 0.2, 200, 1e-3)  # alpha, w_reg, max_iter, threshold


def _port_solve(d, psi_inv0, **kw):
    T = torch.from_numpy
    return ts.estimate_psi_compositive(
        T(d["psi0"]), T(d["tg"]), T(d["wg"]), T(d["tn"]), T(d["wn"]),
        ts.sobolev_filter_1d(7, 0.1), *SOLVE_ARGS, T(d["psi_inv0"]) if psi_inv0 else None,
        **kw,
    )


@pytest.fixture(scope="module", params=sorted(SOLVE_CASES))
def compositive_runs(request):
    """(port, JAX) on a psi0 that has drifted 2.5 voxels in x (past the K=2
    window) with a 0.4-voxel increment to solve."""
    with_inv, skip = SOLVE_CASES[request.param]
    d = _scene(0.125 + 2.9 * VS, _disp0(2.5, 0.3))
    kw = dict(SOLVE_KW, skip_inv_warps=skip)
    port = _port_solve(d, with_inv, **kw)
    j = jnp.asarray
    # the port's skip_inv_warps skips the inverse too: JAX takes both flags
    want = js.estimate_psi_compositive(
        j(d["psi0"]), j(d["tg"]), j(d["wg"]), j(d["tn"]), j(d["wn"]),
        j(js.sobolev_filter_1d(7, 0.1)), F32(SOLVE_ARGS[0]), F32(SOLVE_ARGS[1]),
        np.int32(SOLVE_ARGS[2]), F32(SOLVE_ARGS[3]), j(d["psi_inv0"]) if with_inv else None,
        skip_inverse=skip, **kw,
    )
    return port, want, skip


def test_compositive_iterations_match_jax(compositive_runs):
    """The same iteration count (coarse increment level + fine loop), the
    fine loop ending on the stall below the cap."""
    port, want, _ = compositive_runs
    assert port.iters == int(want.iters) < 400
    assert 0 < port.coarse_iters < port.iters
    np.testing.assert_allclose(port.max_norm, float(want.max_norm), rtol=1e-4)


def test_compositive_fields_match_jax(compositive_runs):
    port, want, skip = compositive_runs
    np.testing.assert_allclose(_np(port.psi), _np(want.psi), atol=2e-5)
    np.testing.assert_allclose(_np(port.psi_inv), _np(want.psi_inv), atol=2e-5)
    np.testing.assert_allclose(_np(port.tsdf_n_psi), _np(want.tsdf_n_psi), atol=1e-5)
    np.testing.assert_array_equal(_np(port.weight_n_psi), _np(want.weight_n_psi))
    np.testing.assert_allclose(_np(port.tsdf_global_psi_inv), _np(want.tsdf_global_psi_inv),
                               atol=1e-5)
    np.testing.assert_array_equal(_np(port.weight_global_psi_inv),
                                  _np(want.weight_global_psi_inv))
    if skip:
        np.testing.assert_array_equal(_np(port.psi_inv),
                                      _scene(0.125, _disp0(2.5, 0.3))["psi_inv0"])


def test_compositive_energy_rows_match_jax():
    """record_energy: the rows of the fine loop (data energy, the
    regulariser of the increment, the update norm) at rtol 1e-4."""
    d = _scene(0.125 + 2.9 * VS, _disp0(2.5, 0.3))
    kw = dict(warp_window=2, momentum=0.9, inverse_iters=2, record_energy=True,
              energy_cap=24)
    T = torch.from_numpy
    port = ts.estimate_psi_compositive(
        T(d["psi0"]), T(d["tg"]), T(d["wg"]), T(d["tn"]), T(d["wn"]),
        ts.sobolev_filter_1d(7, 0.1), 0.05, 0.2, 24, -1.0, **kw)
    j = jnp.asarray
    want = js.estimate_psi_compositive(
        j(d["psi0"]), j(d["tg"]), j(d["wg"]), j(d["tn"]), j(d["wn"]),
        j(js.sobolev_filter_1d(7, 0.1)), F32(0.05), F32(0.2), np.int32(24), F32(-1.0), **kw)
    assert port.iters == int(want.iters) == 24
    np.testing.assert_allclose(port.energy.numpy(), np.asarray(want.energy), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(port.psi.numpy(), np.asarray(want.psi), atol=2e-5)


def test_fused_composition_matches_exact_inside_the_window():
    """fused=True composes with the window-K field sample (kernel B, C=3)
    where JAX's exact branch gathers; while the increment stays inside the
    window the two agree (atol 2e-5, the bound of JAX's own
    test_compositive_fused_matches_xla)."""
    d = _scene(0.125 + 2.9 * VS, _disp0(2.5, 0.3))
    fused = _port_solve(d, True, fused=True, **SOLVE_KW)
    exact = _port_solve(d, True, **SOLVE_KW)
    assert fused.iters == exact.iters
    np.testing.assert_allclose(fused.psi.numpy(), exact.psi.numpy(), atol=2e-5)
    np.testing.assert_allclose(fused.psi_inv.numpy(), exact.psi_inv.numpy(), atol=2e-5)


@pytest.fixture(scope="module")
def fine_window_runs():
    """estimate_psi_pyramid(fine_window=1) with the production momentum and
    stall stop, from a warm psi0 and psi_inv0 inside the K=2 window."""
    d = _scene(0.118, _disp0(0.3, 0.2))
    kw = dict(levels=2, warp_window=2, fine_window=1, momentum=0.95, stall_window=16,
              stall_rel=1e-2, inverse_iters=3)
    T = torch.from_numpy
    taps = ts.sobolev_filter_1d(7, 0.1)
    port = ts.estimate_psi_pyramid(
        T(d["psi0"]), T(d["tg"]), T(d["wg"]), T(d["tn"]), T(d["wn"]), taps, *SOLVE_ARGS,
        T(d["psi_inv0"]), fused=False, **kw)
    j = jnp.asarray
    want = js.estimate_psi_pyramid(
        j(d["psi0"]), j(d["tg"]), j(d["wg"]), j(d["tn"]), j(d["wn"]), j(taps),
        F32(SOLVE_ARGS[0]), F32(SOLVE_ARGS[1]), np.int32(SOLVE_ARGS[2]), F32(SOLVE_ARGS[3]),
        j(d["psi_inv0"]), fused_db=False, **kw)
    return port, want


def test_fine_window_pyramid_matches_jax(fine_window_runs):
    port, want = fine_window_runs
    assert port.iters == int(want.iters) and 0 < port.coarse_iters < port.iters
    for field, atol in (("psi", 2e-5), ("psi_inv", 2e-5), ("tsdf_n_psi", 1e-5),
                        ("tsdf_global_psi_inv", 1e-5), ("weight_n_psi", 0),
                        ("weight_global_psi_inv", 0)):
        np.testing.assert_allclose(_np(getattr(port, field)), _np(getattr(want, field)),
                                   atol=atol, err_msg=field)


def test_compositive_inv_coarse_needs_the_multigrid_carry():
    d = _scene(0.118, _disp0(0.3, 0.2))
    with pytest.raises(ValueError, match="inv_coarse"):
        _port_solve(d, True, warp_window=1, total_window=2, inv_coarse=True,
                    inv_multigrid=True, skip_inv_warps=False)


# ---------------------------------------------------------------------------
# the frame loop
# ---------------------------------------------------------------------------

H, W = 48, 64
DIM = 32


def _params(cfg, **keys):
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
    p.w_reg = 0.2
    for k, v in keys.items():
        setattr(p, k, v)
    return p


def _frames(step):
    intr = (60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5)
    return [make_synthetic_scene.render_prims_depth(H, W, *intr, [((step * i, 0.0, 0.45), 0.08)])
            for i in range(4)]


# the drift keys of bench.py's compositive cell (SOLVER_MODE=compositive,
# momentum 0.9, the increment pyramid, the stall stop) at 32^3, and the
# production scene ini's keys (tools/make_synthetic_scene.py --production:
# a pyramid with the compositive FINE_WINDOW=1 fine level)
COMPOSITIVE_KEYS = dict(solver_mode="compositive", warp_window=2, momentum=0.9, alpha=0.05,
                        pyramid_levels=2, max_iter=64, max_update_norm=4e-3, stall_window=16,
                        stall_rel=1e-2)
FINE_WINDOW_KEYS = dict(warp_window=2, momentum=0.95, alpha=0.05, pyramid_levels=2,
                        fine_window=1, max_iter=64, max_update_norm=4e-3, stall_window=16,
                        stall_rel=1e-2)
# (keys, need_inv_warps, step in metres per frame): 12 mm is ~1 voxel, so
# the accumulated motion leaves the K=2 window by the last frame
# psi and psi_inv after three solve frames: each composition psi0 o g adds an
# ulp or two where g's absolute coordinates differ from JAX's id + delta in
# the last bit (measured 1.1e-5, 1.9e-5, 2.7e-5 after frames 1-3), and the
# coordinates reach 34, where an ulp is 3.8e-6: atol 3e-5, 8 ulps there
FIELD_ATOL = 3e-5
PIPELINE_CONFIGS = {
    "compositive-nolog": (COMPOSITIVE_KEYS, False, 0.012),
    "compositive-log": (COMPOSITIVE_KEYS, True, 0.012),
    "compositive-gate": (dict(COMPOSITIVE_KEYS, new_surface_gate=1.5), False, 0.012),
    "fine-window-nolog": (FINE_WINDOW_KEYS, False, 0.005),
}


@pytest.fixture(scope="module", params=sorted(PIPELINE_CONFIGS))
def pipeline_runs(request):
    """Both packages over the same 4 frames; the port's kernels.warp_fuse
    calls are counted."""
    keys, need_inv, step = PIPELINE_CONFIGS[request.param]
    fj = jp.SobFusion(_params(jc, **keys))
    ft = tp.SobFusion(_params(tc, **keys), device="cpu")
    fj.need_inv_warps = ft.need_inv_warps = need_inv
    iters = []
    fuse_calls = []
    orig = kernels.warp_fuse

    def spy(*a, **k):
        fuse_calls.append(1)
        return orig(*a, **k)

    kernels.warp_fuse = spy
    try:
        for depth in _frames(step):
            fj(jnp.asarray(depth))
            ft(depth)
            if ft.last_solve is not None:
                iters.append((ft.last_solve.iters, int(fj.last_solve.iters)))
    finally:
        kernels.warp_fuse = orig
    return fj, ft, iters, len(fuse_calls)


def test_compositive_pipeline_canonical_matches_jax(pipeline_runs):
    fj, ft, _, _ = pipeline_runs
    np.testing.assert_allclose(ft.phi_global.tsdf.numpy(), np.asarray(fj.phi_global.tsdf),
                               atol=1e-5)
    np.testing.assert_array_equal(ft.phi_global.weight.numpy(),
                                  np.asarray(fj.phi_global.weight))
    assert float(ft.phi_global.weight.sum()) > 0


def test_compositive_pipeline_fields_and_iterations_match_jax(pipeline_runs):
    fj, ft, iters, _ = pipeline_runs
    assert len(iters) == 3
    for port_iters, jax_iters in iters:
        assert port_iters == jax_iters < 2 * ft.params.max_iter
    np.testing.assert_allclose(ft.psi.data.numpy(), np.asarray(fj.psi.data), atol=FIELD_ATOL)
    np.testing.assert_allclose(ft.psi_inv.data.numpy(), np.asarray(fj.psi_inv.data),
                               atol=FIELD_ATOL)


def test_compositive_pipeline_live_and_inverse_warps_match_jax(pipeline_runs):
    """phi_n o psi's weight is the solve's own floor warp (never left
    stale, never warped a second time through warp_fuse); phi_global o
    psi_inv, refreshed on demand in the no-log loops (compositive mode: the
    exact cold 48-step inverse), matches JAX's."""
    fj, ft, _, fuse_calls = pipeline_runs
    assert fuse_calls == 0 and not ft._n_psi_weight_stale
    np.testing.assert_array_equal(ft.phi_n_psi.weight.numpy(),
                                  np.asarray(fj.phi_n_psi.weight))
    fj.get_phi_global_psi_inv_mesh()
    ft.get_phi_global_psi_inv_mesh()
    np.testing.assert_allclose(ft.psi_inv.data.numpy(), np.asarray(fj.psi_inv.data),
                               atol=FIELD_ATOL)
    np.testing.assert_allclose(ft.phi_global_psi_inv.tsdf.numpy(),
                               np.asarray(fj.phi_global_psi_inv.tsdf), atol=1e-5)
    np.testing.assert_array_equal(ft.phi_global_psi_inv.weight.numpy(),
                                  np.asarray(fj.phi_global_psi_inv.weight))


def test_compositive_mode_keeps_the_full_res_inverse():
    """Repair: the half-res inverse carry is additive-only
    (sobfu_tpu/pipeline.py:305). In compositive mode with a pyramid, the
    fused dispatch and INV_COARSE, psi_inv stays full resolution, as in
    JAX."""
    keys = dict(COMPOSITIVE_KEYS, fused_pallas=True, inv_coarse=True)
    fj = jp.SobFusion(_params(jc, **keys))
    ft = tp.SobFusion(_params(tc, **keys), device="cpu")
    fj.need_inv_warps = ft.need_inv_warps = False
    depth = _frames(0.012)[0]
    fj(jnp.asarray(depth))
    ft(depth)
    assert ft.solver.inv_coarse and fj.solver.inv_coarse
    assert ft._coarse_inv_carry() is fj._coarse_inv_carry() is False
    assert tuple(ft.psi_inv.data.shape) == tuple(fj.psi_inv.data.shape) == (3,) + (DIM,) * 3


@pytest.mark.parametrize("mode", ["compositive", "additive"])
def test_weight_warp_is_skipped_only_in_the_additive_mode(mode):
    """Repair: the no-log loop leaves weight_n's floor warp to the fuse only
    in the additive mode (sobfu_tpu/pipeline.py:390-397); the port also
    keeps it in the solve for a compositive fine level."""
    keys = COMPOSITIVE_KEYS if mode == "compositive" else dict(COMPOSITIVE_KEYS,
                                                                solver_mode="additive")
    ft = tp.SobFusion(_params(tc, **dict(keys, volume_dims=(16,) * 3)), device="cpu")
    ft.need_inv_warps = False
    ft(_frames(0.012)[0])
    assert ft._skip_weight_warp() is (mode == "additive")
    ft.solver.fine_window = 1
    assert ft._skip_weight_warp() is False
    ft.need_inv_warps = True
    ft.solver.fine_window = None
    assert ft._skip_weight_warp() is False


@pytest.mark.parametrize("incremental,warm", [(False, True), (True, False)])
def test_compositive_psi_inv0_follows_incremental_inverse(monkeypatch, incremental, warm):
    """Repair: in compositive mode the frame step passes the previous psi_inv
    by INCREMENTAL_INV, not by inverse_warm (sobfu_tpu/pipeline.py:414-420)."""
    seen = []
    orig = ts.estimate_psi_compositive

    def spy(*a, **k):
        seen.append(a[10] is not None)
        return orig(*a, **k)

    monkeypatch.setattr(ts, "estimate_psi_compositive", spy)
    keys = dict(COMPOSITIVE_KEYS, volume_dims=(16,) * 3, max_iter=4,
                incremental_inverse=incremental, inverse_warm=warm)
    ft = tp.SobFusion(_params(tc, **keys), device="cpu")
    for depth in _frames(0.012)[:3]:
        ft(depth)
    assert seen == [incremental] * 2


def test_cli_runs_the_production_scene_ini(tmp_path):
    """python -m sobfu_tpu_torch accepts the ini that make_synthetic_scene.py
    --production writes (PYRAMID_LEVELS=2 with FINE_WINDOW=1)."""
    from sobfu_tpu_torch import cli

    scene = tmp_path / "scene"
    make_synthetic_scene.main([str(scene), "--frames", "3", "--dim", "16", "--width", "64",
                               "--height", "48", "--production"])
    ini = scene / "params.ini"
    ini.write_text(ini.read_text() + "MAX_ITER=8\n")
    p = tc.load_params(str(ini))
    assert p.fine_window == 1 and p.pyramid_levels == 2
    assert cli.main([str(scene), str(ini), "--device", "cpu", "--enable-log"]) == 0
    assert sorted(os.listdir(scene / "meshes")) == ["mesh_0001.vtk", "mesh_0002.vtk"]
