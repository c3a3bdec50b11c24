"""The kernel wrappers of sobfu_tpu_torch.ops.kernels.

On the CPU each wrapper runs its plain torch version; these are held to the
JAX package's XLA references — the same references its own Pallas tests use
(tests/test_pallas.py: _xla_step, sample_*_window, estimate_inverse_window,
sample_nearest_floor_window + fuse_volumes) — and to the Pallas entry points
that kernels A and C serve, run in interpret mode. Inputs come from numpy
with a seed. tests/test_torch_cuda.py holds each kernel to its plain
version on a CUDA card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import fields as jf
from sobfu_tpu import solver as js
from sobfu_tpu.tsdf import fuse_volumes as j_fuse
from sobfu_tpu_torch.ops import kernels

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)

DIMS = (12, 16, 20)  # non-cubic: catches a (z*Y + y)*X + x indexing slip


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _inputs(dims=DIMS, amp=1.5, seed=2):
    """tg, live, psi, tnp, vel as numpy f32 (psi = identity + noise)."""
    rng = np.random.default_rng(seed)
    ident = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")[::-1])
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        tg=f(rng.standard_normal(dims)),
        live=f(rng.standard_normal(dims)),
        psi=f(ident + rng.uniform(-amp, amp, (3,) + dims)),
        tnp=f(rng.standard_normal(dims)),
        vel=f(rng.standard_normal((3,) + dims)),
    )


def _jax_step(d, taps, alpha, w_reg, momentum, K):
    """solver.estimate_psi's XLA iteration (tests/test_pallas.py _xla_step,
    with momentum and the exact warp)."""
    psi, tnp, tg, live = (jnp.asarray(d[k]) for k in ("psi", "tnp", "tg", "live"))
    grad = jf.tsdf_gradient(tnp)
    lap = jf.neg_laplacian(psi)
    dU_S = js.sobolev_smooth((tnp - tg)[None] * grad + w_reg * lap, jnp.asarray(taps))
    vel = None
    if momentum is not None:
        vel = momentum * jnp.asarray(d["vel"]) + dU_S
        upd = alpha * vel
    else:
        upd = alpha * dU_S
    psi_new = psi - upd
    if K is None:
        tnp_new = jf.sample_trilinear(live, psi_new)
    else:
        tnp_new = jf.sample_trilinear_window(live, psi_new, K)
    return psi_new, tnp_new, vel, float(jnp.max(jnp.sum(upd * upd, axis=0)))


# (K, taps, momentum): the TPU kernel tests' cases plus the exact warp
GD_CASES = [(1, 3, None), (2, 7, None), (2, 7, 0.9), (1, 3, 0.9), (None, 7, None)]


@pytest.mark.parametrize("K,s,momentum", GD_CASES)
def test_gd_iteration_plain_matches_jax(K, s, momentum):
    """Tolerance atol 1e-5, the JAX kernel tests' bound (test_pallas.py:51);
    the same op sequence lands within a few ulps."""
    d = _inputs()
    taps = js.sobolev_filter_1d(s, 0.1)
    alpha, w_reg = 0.05, 0.2
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    got = kernels.gd_iteration(
        t["psi"], t["tnp"], t["vel"], t["tg"], t["live"], torch.from_numpy(taps),
        alpha, w_reg, momentum, K,
    )
    want = _jax_step(d, taps, np.float32(alpha), np.float32(w_reg), momentum, K)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=1e-5)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=1e-5)
    if momentum is None:
        assert got[2] is None
    else:
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), atol=1e-5)
    np.testing.assert_allclose(float(got[3]), want[3], rtol=1e-4)


@pytest.mark.parametrize("K", [None, 1, 2])
def test_warp_plain_matches_jax(K):
    """Trilinear at atol 1e-6 (same op order); floor channels bit for bit.
    Displacements reach 3 voxels, past the K=1 and K=2 windows."""
    d = _inputs(amp=3.0, seed=4)
    vol = np.stack([d["tg"], np.round(np.abs(d["live"]) * 2).astype(np.float32)])
    got = kernels.warp(torch.from_numpy(vol), torch.from_numpy(d["psi"]), K, (False, True))
    jv, jp = jnp.asarray(vol), jnp.asarray(d["psi"])
    if K is None:
        tri, flo = jf.sample_trilinear(jv[0], jp), jf.sample_nearest_floor(jv[1], jp)
    else:
        tri = jf.sample_trilinear_window(jv[0], jp, K)
        flo = jf.sample_nearest_floor_window(jv[1], jp, K)
    np.testing.assert_allclose(_np(got[0]), _np(tri), atol=1e-6)
    np.testing.assert_array_equal(_np(got[1]), _np(flo))


@pytest.mark.parametrize("K,iters,warm", [(2, 3, True), (2, 3, False), (None, 48, False),
                                          (None, 4, True)])
def test_inverse_fixed_point_plain_matches_jax(K, iters, warm):
    """The warm 3-step window inverse of the slice and the 48-step exact
    inverse from identity. Sub-voxel displacements keep the fixed point a
    contraction, so ulp differences do not grow past 1e-5."""
    d = _inputs(amp=0.3, seed=6)
    init = _inputs(amp=0.2, seed=7)["psi"] if warm else None
    got = kernels.inverse_fixed_point(
        torch.from_numpy(d["psi"]), iters, K, None if init is None else torch.from_numpy(init)
    )
    ji = None if init is None else jnp.asarray(init)
    if K is None:
        want = jf.estimate_inverse(jnp.asarray(d["psi"]), iters, init=ji)
    else:
        want = jf.estimate_inverse_window(jnp.asarray(d["psi"]), iters, K, init=ji)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("K", [None, 2])
def test_warp_fuse_plain_bitwise_vs_jax(K):
    """window_warp_fuse_pallas's contract: bit-identical to the floor warp +
    fuse_volumes (pallas_kernels.py:623-626). Weights 0..3 and tsdf values
    0 and -1 exercise every skip rule."""
    rng = np.random.default_rng(9)
    d = _inputs(amp=3.0, seed=8)
    wg = rng.integers(0, 4, DIMS).astype(np.float32)
    wn = rng.integers(0, 2, DIMS).astype(np.float32)
    tnp = d["tnp"].copy()
    tnp[rng.random(DIMS) < 0.1] = 0.0
    tnp[rng.random(DIMS) < 0.1] = -1.0
    got = kernels.warp_fuse(
        torch.from_numpy(d["tg"]), torch.from_numpy(wg), torch.from_numpy(tnp),
        torch.from_numpy(wn), torch.from_numpy(d["psi"]), 3.0, K,
    )
    jp = jnp.asarray(d["psi"])
    wnp = (
        jf.sample_nearest_floor(jnp.asarray(wn), jp)
        if K is None
        else jf.sample_nearest_floor_window(jnp.asarray(wn), jp, K)
    )
    want = j_fuse(jnp.asarray(d["tg"]), jnp.asarray(wg), jnp.asarray(tnp), wnp,
                  jnp.float32(3.0))
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


def test_cpu_tensors_launch_no_kernel():
    kernels.reset_launch_counts()
    d = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    taps = torch.from_numpy(js.sobolev_filter_1d(7, 0.1))
    kernels.gd_iteration(d["psi"], d["tnp"], None, d["tg"], d["live"], taps, 0.1, 0.2,
                         None, 2, with_energy=True)
    kernels.gd_multi(d["psi"], d["tnp"], None, d["tg"], d["live"], taps, 0.1, 0.2, None, 2, 2,
                     with_energy=True, with_verbose=True)
    kernels.warp(d["tg"][None], d["psi"], 2, (False,))
    kernels.inverse_fixed_point(d["psi"], 2, None)
    kernels.warp_fuse(d["tg"], d["tg"], d["tnp"], d["live"], d["psi"], 64.0, 2)
    b = {k: v[None] for k, v in d.items()}
    kernels.gd_iteration_scenes(b["psi"], b["tnp"], None, b["tg"], b["live"], taps, 0.1, 0.2,
                                None, 2, torch.tensor([True]), with_energy=True)
    assert kernels.launch_counts == {k: 0 for k in kernels.launch_counts}


def test_wrappers_reject_other_devices():
    meta = torch.empty((1,) + DIMS, device="meta")
    psi = torch.empty((3,) + DIMS, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.warp(meta, psi, 2, (False,))
    with pytest.raises(ValueError, match="1 entries for 2 channels"):
        kernels.warp(torch.zeros((2,) + DIMS), torch.zeros((3,) + DIMS), 2, (False,))


@pytest.mark.parametrize("K", [None, 2])
def test_gd_iteration_plain_energy_matches_data_energy(K):
    """A's stall energy: 0.5 * sum (tg - tnp')^2, the plain version's
    data_energy of its own tnp' (bit for bit) and JAX's within rtol 1e-5
    (a sum in another order); only returned when asked for."""
    from sobfu_tpu_torch.solver import data_energy

    d = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    taps = torch.from_numpy(js.sobolev_filter_1d(7, 0.1))
    args = (d["psi"], d["tnp"], d["vel"], d["tg"], d["live"], taps, 0.05, 0.2, 0.9, K)
    got = kernels.gd_iteration(*args, with_energy=True)
    assert torch.equal(got[4], data_energy(d["tg"], got[1]))
    want = js.data_energy(jnp.asarray(_np(d["tg"])), jnp.asarray(_np(got[1])))
    np.testing.assert_allclose(float(got[4]), float(want), rtol=1e-5)
    assert len(kernels.gd_iteration(*args)) == 4


# ---------------------------------------------------------------------------
# the TPU entry points A and C serve (ROADMAP Queue 2 items 5, 9, 10, 11),
# each run in Pallas interpret mode at the shapes of its own tests in
# tests/test_pallas.py (:44, :93, :220, :518, :562)
# ---------------------------------------------------------------------------

PALLAS_DIMS = (16, 16, 32)


def _plain_step(d, taps, momentum, K=2, alpha=0.05, w_reg=0.2):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return kernels.gd_iteration_plain(t["psi"], t["tnp"], t["vel"], t["tg"], t["live"],
                                      torch.from_numpy(taps), alpha, w_reg, momentum, K)


def _assert_step(got, want, momentum):
    """(psi', tnp', vel', max_sq) of a Pallas entry point against A's plain
    version: atol 1e-5 on the fields and rtol 1e-4 on the norm, the bounds
    of the entry points' own tests (the sums run in another order)."""
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5)
    if momentum is not None:
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), atol=1e-5)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-4)


@pytest.mark.parametrize("momentum,x_pad_to", [(None, 0), (0.9, 0), (0.9, 64)])
def test_fused_gd_iteration_db_matches_plain(momentum, x_pad_to):
    """fused_gd_iteration_db (:1023, its pallas_call :1208 under
    fused_gd_iteration_db_padded), unpadded and lane-packed to 64 lanes."""
    from sobfu_tpu.ops.pallas_kernels import fused_gd_iteration_db, pad_for_db

    d = _inputs(PALLAS_DIMS, seed=3)
    taps = js.sobolev_filter_1d(7, 0.1)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    got = fused_gd_iteration_db(
        j["psi"], j["tnp"], j["vel"] if momentum is not None else None,
        pad_for_db(j["tg"], x_pad_to), pad_for_db(j["live"], x_pad_to),
        jnp.float32(0.05), jnp.float32(0.2), tuple(float(t) for t in taps),
        K=2, BZ=8, TY=16, momentum=momentum, interpret=True, x_pad_to=x_pad_to,
    )
    _assert_step(got, _plain_step(d, taps, momentum), momentum)


def test_fused_gd_step_matches_plain():
    """fused_gd_step (:1854), the compatibility wrapper over the db kernel."""
    from sobfu_tpu.ops.pallas_kernels import fused_gd_step

    d = _inputs(PALLAS_DIMS, seed=2)
    taps = js.sobolev_filter_1d(7, 0.1)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    psi, tnp, mx = fused_gd_step(j["psi"], j["tnp"], j["tg"], j["live"], jnp.float32(0.05),
                                 jnp.float32(0.2), tuple(float(t) for t in taps), K=2, BZ=4,
                                 TY=8, interpret=True)
    _assert_step((psi, tnp, None, mx), _plain_step(d, taps, None), None)


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_fused_gd_iteration_stacked_matches_plain(momentum):
    """fused_gd_iteration_stacked (:1951, pallas_call :2051)."""
    from sobfu_tpu.ops.pallas_kernels import _stack_db, fused_gd_iteration_stacked

    d = _inputs(PALLAS_DIMS, seed=11)
    d["tnp"] = np.array(jf.sample_trilinear_window(jnp.asarray(d["live"]),
                                                   jnp.asarray(d["psi"]), 2))
    taps = js.sobolev_filter_1d(7, 0.1)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    got = fused_gd_iteration_stacked(
        j["psi"], j["tnp"], j["vel"] if momentum is not None else None,
        _stack_db(j["tg"], TY=16), _stack_db(j["live"], TY=16), jnp.float32(0.05),
        jnp.float32(0.2), tuple(float(t) for t in taps), K=2, TY=16, momentum=momentum,
        interpret=True,
    )
    _assert_step(got, _plain_step(d, taps, momentum), momentum)


@pytest.mark.parametrize("iters,warm", [(6, False), (4, True)])
def test_estimate_inverse_window_pallas_matches_plain(iters, warm):
    """estimate_inverse_window_pallas (:1883, step-chained window warps)
    against C's plain version, cold and warm-started, atol 1e-5."""
    from sobfu_tpu.ops.pallas_kernels import estimate_inverse_window_pallas

    d = _inputs(PALLAS_DIMS, amp=1.2, seed=3)
    init = _inputs(PALLAS_DIMS, amp=0.3, seed=4)["psi"] if warm else None
    got = estimate_inverse_window_pallas(jnp.asarray(d["psi"]), iters=iters, K=2,
                                         init=None if init is None else jnp.asarray(init),
                                         interpret=True)
    want = kernels.inverse_fixed_point(torch.from_numpy(d["psi"]), iters, 2,
                                       None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


# ---------------------------------------------------------------------------
# A over scenes
# ---------------------------------------------------------------------------


def _scenes(S, dims=DIMS, amp=1.5, seed=20):
    per = [_inputs(dims, amp, seed + s) for s in range(S)]
    return {k: torch.from_numpy(np.stack([p[k] for p in per])) for k in per[0]}


@pytest.mark.parametrize("K,momentum,with_energy", [(2, 0.95, True), (None, None, False),
                                                    (1, 0.9, False)])
def test_gd_iteration_scenes_plain_bitwise_vs_unbatched(K, momentum, with_energy):
    """Each active scene equals gd_iteration on that scene bit for bit
    (state, norm, energy); the inactive scene keeps psi, tnp and vel and
    reports 0."""
    b = _scenes(3)
    taps = torch.from_numpy(js.sobolev_filter_1d(7, 0.1))
    active = torch.tensor([True, False, True])
    out = kernels.gd_iteration_scenes(b["psi"], b["tnp"], b["vel"], b["tg"], b["live"], taps,
                                      0.05, 0.2, momentum, K, active, with_energy=with_energy)
    assert len(out) == (5 if with_energy else 4) and out[3].shape == (3,)
    assert (out[2] is None) == (momentum is None)
    for s in (0, 2):
        one = kernels.gd_iteration(b["psi"][s], b["tnp"][s], b["vel"][s], b["tg"][s],
                                   b["live"][s], taps, 0.05, 0.2, momentum, K,
                                   with_energy=with_energy)
        for g, w in zip(out, one):
            if w is not None:
                assert torch.equal(g[s], w)
    assert torch.equal(out[0][1], b["psi"][1]) and torch.equal(out[1][1], b["tnp"][1])
    if momentum is not None:
        assert torch.equal(out[2][1], b["vel"][1])
    assert all(float(o[1]) == 0.0 for o in out[3:])


@pytest.mark.parametrize("momentum,with_energy,with_verbose", [(0.95, True, True),
                                                               (None, True, False),
                                                               (0.9, False, False)])
def test_gd_multi_plain_bitwise_vs_chained(momentum, with_energy, with_verbose):
    """E's plain version with n_inner=3 against 3 chained plain A steps:
    state, velocity, every norm row and every energy row bit for bit; the
    verbose rows are the pre-update energies of each step."""
    from sobfu_tpu_torch.solver import data_energy, reg_energy_sobolev

    d = {k: torch.from_numpy(v) for k, v in _inputs((8, 8, 64), amp=0.8, seed=12).items()}
    taps = torch.from_numpy(js.sobolev_filter_1d(7, 0.1))
    args = (d["psi"], d["tnp"], d["vel"], d["tg"], d["live"], taps, 0.05, 0.2, momentum, 1)
    out = kernels.gd_multi(*args, 3, with_energy=with_energy, with_verbose=with_verbose)
    psi, tnp, vel = d["psi"], d["tnp"], d["vel"]
    for it in range(3):
        if with_verbose:
            assert torch.equal(out.e_pre[it], data_energy(d["tg"], tnp))
            assert torch.equal(out.e_reg[it], reg_energy_sobolev(psi))
        step = kernels.gd_iteration(
            psi, tnp, vel, d["tg"], d["live"], taps, 0.05, 0.2, momentum, 1,
            with_energy=with_energy,
        )
        psi, tnp, vel = step[:3]
        assert torch.equal(out.mx_sq[it], step[3])
        if with_energy:
            assert torch.equal(out.e_data[it], step[4])
    assert torch.equal(out.psi, psi) and torch.equal(out.tnp, tnp)
    assert (out.vel is None) == (momentum is None)
    if momentum is not None:
        assert torch.equal(out.vel, vel)
    assert (out.e_data is None) != with_energy
    assert (out.e_pre is None) != with_verbose
