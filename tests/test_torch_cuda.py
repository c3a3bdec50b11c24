"""The CUDA kernels on the card: each against its plain torch version, the
solver (single-level, pyramid and compositive) on the card against its
goldens, and a checkpoint resumed on the card, through SobFusion and
through the CLI, against an uninterrupted run, bit for bit.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither jax nor sobfu_tpu, so it runs where only torch is
installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: atol 1e-5 (the JAX kernel tests' bound) for the trilinear
outputs — the kernels are built with --fmad=false and add in the plain
versions' order, so they land on the same bits in practice; bitwise for the
floor-corner warp, the fuse and kernel F (whose floor index reads its own
trilinear output).
"""

import os

import numpy as np
import pytest
import torch

from sobfu_tpu_torch import fields, solver
from sobfu_tpu_torch.ops import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (12, 16, 20)  # non-cubic: catches a (z*Y + y)*X + x indexing slip
GD_CASES = [(1, 3, None), (2, 7, None), (2, 7, 0.9), (1, 3, 0.9), (None, 7, None)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, amp, seed=2):
    rng = np.random.default_rng(seed)
    ident = np.stack(np.meshgrid(*[np.arange(d) for d in DIMS], indexing="ij")[::-1])
    arrays = dict(
        tg=rng.standard_normal(DIMS),
        live=rng.standard_normal(DIMS),
        psi=ident + rng.uniform(-amp, amp, (3,) + DIMS),
        tnp=rng.standard_normal(DIMS),
        vel=rng.standard_normal((3,) + DIMS),
    )
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in arrays.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("K,s,momentum", GD_CASES)
def test_gd_iteration_kernel_matches_plain(cuda, K, s, momentum):
    d = _inputs(cuda, 1.5)
    taps = torch.as_tensor(solver.sobolev_filter_1d(s, 0.1), device=cuda)
    args = (d["psi"], d["tnp"], d["vel"], d["tg"], d["live"], taps, 0.05, 0.2, momentum, K)
    got, want = kernels.gd_iteration(*args), kernels.gd_iteration_plain(*args)
    for g, w in zip(got[:3], want[:3]):
        if w is not None:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    torch.testing.assert_close(got[3], want[3], atol=0, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 1, 2])
def test_warp_kernel_matches_plain(cuda, K):
    d = _inputs(cuda, 3.0)
    vol = torch.stack([d["tg"], d["live"].abs().round()])
    got = kernels.warp(vol, d["psi"], K, (False, True))
    want = kernels.warp_plain(vol, d["psi"], K, (False, True))
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("K,iters,warm", [(2, 3, True), (2, 3, False), (None, 48, False)])
def test_inverse_kernel_matches_plain(cuda, K, iters, warm):
    d = _inputs(cuda, 0.3)
    init = _inputs(cuda, 0.2, seed=7)["psi"] if warm else None
    got = kernels.inverse_fixed_point(d["psi"], iters, K, init)
    want = kernels.inverse_fixed_point_plain(d["psi"], iters, K, init)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 2])
def test_warp_fuse_kernel_bitwise(cuda, K):
    d = _inputs(cuda, 3.0)
    wg = d["live"].abs().round()
    wn = (d["tnp"] > 0).float()
    tnp = torch.where(d["vel"][0] > 1.0, 0.0, d["tnp"])
    args = (d["tg"], wg, tnp, wn, d["psi"], 2.0, K)
    got, want = kernels.warp_fuse(*args), kernels.warp_fuse_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_wrappers_validate_operands(cuda):
    d = _inputs(cuda, 1.0)
    with pytest.raises(TypeError, match="float32"):
        kernels.warp(d["tg"][None].double(), d["psi"], 2, (False,))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.warp(d["tg"].transpose(0, 2)[None], d["psi"].transpose(1, 3), 2, (False,))
    with pytest.raises(ValueError, match="shape"):
        kernels.inverse_fixed_point(d["psi"][:, :4].contiguous(), 3, 2, init=d["psi"])
    with pytest.raises(ValueError, match="on cpu"):
        kernels.warp_fuse(d["tg"], d["tg"], d["tg"], d["tg"].cpu(), d["psi"], 64.0, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("name,K", [("solver_16.npz", None), ("solver_16_window.npz", 2)])
def test_solver_on_card_matches_golden(cuda, name, K):
    from sobfu_tpu_torch.tsdf import init_sphere

    dims, vs = (16, 16, 16), 0.25 / 16
    tg, wg = init_sphere(dims, (vs,) * 3, (0.125,) * 3, 0.04, 8 * vs, 3 * vs, device=cuda)
    tn, wn = init_sphere(dims, (vs,) * 3, (0.118, 0.125, 0.125), 0.04, 8 * vs, 3 * vs,
                         device=cuda)
    kernels.reset_launch_counts()
    res = solver.estimate_psi(
        fields.identity_field(dims, device=cuda), tg, wg, tn, wn,
        solver.sobolev_filter_1d(7, 0.1), 0.1, 0.3, 32, -1.0, inverse_iters=8, warp_window=K,
    )
    assert kernels.launch_counts["gd_iteration"] == 32
    assert kernels.launch_counts["inverse_fixed_point"] == 1
    g = np.load(os.path.join(ROOT, "tests", "golden", name))
    np.testing.assert_allclose(res.psi.cpu().numpy(), g["psi"], atol=1e-5)
    np.testing.assert_allclose(res.tsdf_n_psi.cpu().numpy(), g["tnp"], atol=1e-5)
    np.testing.assert_allclose(res.psi_inv.cpu().numpy(), g["psi_inv"], atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 2])
def test_gd_iteration_energy_on_card(cuda, K):
    """A's stall energy: within rtol 1e-5 of the plain data_energy (a sum in
    another order) and the same bits on every run (fixed-order reduction)."""
    d = _inputs(cuda, 1.5)
    taps = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1), device=cuda)
    args = (d["psi"], d["tnp"], d["vel"], d["tg"], d["live"], taps, 0.05, 0.2, 0.95, K)
    got = kernels.gd_iteration(*args, with_energy=True)
    want = kernels.gd_iteration_plain(*args, with_energy=True)
    torch.testing.assert_close(got[4], want[4], atol=0, rtol=1e-5)
    assert torch.equal(kernels.gd_iteration(*args, with_energy=True)[4], got[4])
    assert len(kernels.gd_iteration(*args)) == 4


# (dims, K, momentum): the coarse level's fold shapes and a non-cubic grid
MULTI_CASES = [((8, 8, 64), 1, 0.95), ((16, 16, 64), 1, 0.95), ((12, 16, 20), 2, None),
               ((12, 16, 20), None, 0.9)]


def _multi_inputs(dev, dims, seed=5):
    rng = np.random.default_rng(seed)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in dims], indexing="ij")[::-1])
    arrays = dict(
        tg=rng.standard_normal(dims) * 0.3,
        live=rng.standard_normal(dims) * 0.3,
        psi=ident + rng.uniform(-0.8, 0.8, (3,) + dims),
        tnp=rng.standard_normal(dims) * 0.3,
        vel=rng.standard_normal((3,) + dims) * 0.1,
    )
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in arrays.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dims,K,momentum", MULTI_CASES)
def test_gd_multi_bitwise_vs_chained_gd_iteration(cuda, dims, K, momentum):
    """E with n_inner=16 equals 16 chained A launches bit for bit: state,
    velocity, every norm row and every energy row."""
    d = _multi_inputs(cuda, dims)
    taps = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1), device=cuda)
    args = (d["psi"], d["tnp"], d["vel"], d["tg"], d["live"], taps, 0.05, 0.2, momentum, K)
    out = kernels.gd_multi(*args, 16, with_energy=True, with_verbose=True)
    psi, tnp, vel = d["psi"], d["tnp"], d["vel"]
    for it in range(16):
        psi, tnp, vel, mx, e = kernels.gd_iteration(
            psi, tnp, vel, d["tg"], d["live"], taps, 0.05, 0.2, momentum, K, with_energy=True
        )
        assert torch.equal(out.mx_sq[it], mx), it
        assert torch.equal(out.e_data[it], e), it
    assert torch.equal(out.psi, psi) and torch.equal(out.tnp, tnp)
    if momentum is not None:
        assert torch.equal(out.vel, vel)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,K,momentum", MULTI_CASES)
@pytest.mark.parametrize("verbose", [False, True])
def test_gd_multi_matches_plain(cuda, dims, K, momentum, verbose):
    """E against its plain version: atol 1e-5 on the state, rtol 1e-5 on the
    norm and energy rows (sums in another order)."""
    d = _multi_inputs(cuda, dims)
    taps = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1), device=cuda)
    args = (d["psi"], d["tnp"], d["vel"], d["tg"], d["live"], taps, 0.05, 0.2, momentum, K,
            16)
    got = kernels.gd_multi(*args, with_energy=True, with_verbose=verbose)
    want = kernels.gd_multi_plain(*args, with_energy=True, with_verbose=verbose)
    for g, w in zip(got[:3], want[:3]):
        if w is not None:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    for g, w in zip(got[3:], want[3:]):
        if w is not None:
            torch.testing.assert_close(g, w, atol=0, rtol=1e-5)
    assert (got.e_pre is None) != verbose


@pytest.mark.cuda
def test_pyramid_on_card_matches_golden(cuda):
    """tests/golden/solver_16_pyramid.npz on the card (atol 1e-5)."""
    from sobfu_tpu_torch.tsdf import init_sphere

    dims, vs = (16, 16, 16), 0.25 / 16
    tg, wg = init_sphere(dims, (vs,) * 3, (0.125,) * 3, 0.04, 8 * vs, 3 * vs, device=cuda)
    tn, wn = init_sphere(dims, (vs,) * 3, (0.118, 0.125, 0.125), 0.04, 8 * vs, 3 * vs,
                         device=cuda)
    kernels.reset_launch_counts()
    res = solver.estimate_psi_pyramid(
        fields.identity_field(dims, device=cuda), tg, wg, tn, wn,
        solver.sobolev_filter_1d(7, 0.1), 0.1, 0.3, 32, -1.0, levels=2, warp_window=2,
        inverse_iters=8,
    )
    assert kernels.launch_counts["gd_iteration"] == 64
    g = np.load(os.path.join(ROOT, "tests", "golden", "solver_16_pyramid.npz"))
    np.testing.assert_allclose(res.psi.cpu().numpy(), g["psi"], atol=1e-5)
    np.testing.assert_allclose(res.tsdf_n_psi.cpu().numpy(), g["tnp"], atol=1e-5)
    np.testing.assert_allclose(res.psi_inv.cpu().numpy(), g["psi_inv"], atol=1e-5)


@pytest.mark.cuda
def test_pyramid_coarse_x64_level_launches_gd_multi(cuda):
    """Fine 16x16x128 with the fused dispatch: the 8x8x64 coarse level runs
    kernel E in chunks of 16, the fine level kernel A, and the multigrid
    inverse kernel C; the result matches the same solve on the CPU."""
    dims = (16, 16, 128)
    rng = np.random.default_rng(5)
    tg = rng.standard_normal(dims).astype(np.float32) * 0.1
    tn = np.roll(tg, 1, axis=2)
    kw = dict(levels=2, warp_window=2, momentum=0.95, inverse_iters=3, stall_window=16,
              stall_rel=1e-2, fused=True, inv_multigrid=True)
    taps = solver.sobolev_filter_1d(7, 0.1)

    def run(dev):
        t = [torch.as_tensor(a, device=dev) for a in (tg, tn)]
        return solver.estimate_psi_pyramid(
            fields.identity_field(dims, device=dev), t[0], t[0], t[1], t[1], taps, 0.05, 0.2,
            40, 1e-3, **kw,
        )

    kernels.reset_launch_counts()
    got = run(cuda)
    assert kernels.launch_counts["gd_multi"] == got.coarse_iters // 16 > 0
    assert kernels.launch_counts["gd_iteration"] == got.iters - got.coarse_iters
    assert kernels.launch_counts["inverse_fixed_point"] == 2
    want = run("cpu")
    assert (got.iters, got.coarse_iters) == (want.iters, want.coarse_iters)
    np.testing.assert_allclose(got.psi.cpu().numpy(), want.psi.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.psi_inv.cpu().numpy(), want.psi_inv.numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("Kf,Kw", [(1, 2), (2, 2)])
def test_compose_weight_kernel_bitwise(cuda, Kf, Kw):
    """F: psi_new and the floor-sampled weight equal the plain version bit
    for bit (an ulp in psi_new could move a floor index across an integer);
    psi0 up to 0.95 and the increment up to Kf - 0.05 voxel from the
    identity, so with Kf=2 psi_new leaves the Kw window and both clamp."""
    rng = np.random.default_rng(11)
    ident = np.stack(np.meshgrid(*[np.arange(d) for d in DIMS], indexing="ij")[::-1])
    arrays = (ident + rng.uniform(-0.95, 0.95, (3,) + DIMS),
              ident + rng.uniform(-(Kf - 0.05), Kf - 0.05, (3,) + DIMS),
              rng.integers(0, 4, DIMS))
    field, pos, weight = (torch.as_tensor(a, dtype=torch.float32, device=cuda) for a in arrays)
    kernels.reset_launch_counts()
    got = kernels.compose_weight(field, pos, weight, Kf, Kw)
    assert kernels.launch_counts["compose_weight"] == 1
    want = kernels.compose_weight_plain(field, pos, weight, Kf, Kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("K,amp", [(1, 0.95), (2, 1.95), (2, 3.5), (None, 3.5)])
def test_warp_field3_kernel_matches_plain(cuda, K, amp):
    """B on three channels, inside and beyond the window and exact, bit for
    bit; counted under warp_field3, not warp."""
    d = _inputs(cuda, amp)
    field = _inputs(cuda, 2.0, seed=9)["psi"]
    kernels.reset_launch_counts()
    got = kernels.warp_field3(field, d["psi"], K)
    assert kernels.launch_counts["warp_field3"] == 1 and kernels.launch_counts["warp"] == 0
    assert torch.equal(got, kernels.warp_field3_plain(field, d["psi"], K))


def _field3_operands(dev, dims, kind, seed=21):
    """(field, pos) on the card: the field id + U(-2, 2); pos id + U(-3.5,
    3.5) ("noise"), chip_smoke.py's smooth field of 3.5 voxels ("smooth"), or
    id + U(-6, 6) with a tenth of the voxels 40 voxels off ("outside")."""
    rng = np.random.default_rng(seed)
    ident = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")[::-1])
    field = ident + rng.uniform(-2.0, 2.0, (3,) + dims)
    if kind == "smooth":
        pos = ident + _chip_smoke().smooth_displacement(dims, 3.5, seed)
    else:
        pos = ident + rng.uniform(-3.5 if kind == "noise" else -6.0,
                                  3.5 if kind == "noise" else 6.0, (3,) + dims)
        if kind == "outside":
            far = rng.random(dims) < 0.1
            pos[:, far] += rng.choice([-40.0, 40.0], (3, int(far.sum())))
    return (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (field, pos))


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["noise", "smooth", "outside"])
@pytest.mark.parametrize("K", [None, 1, 2, 4])
@pytest.mark.parametrize("dims", [(12, 16, 20), (17, 17, 17), (128, 128, 128)])
def test_warp_field3_bitwise_with_plain_and_by_channel(cuda, dims, K, kind):
    """warp_field3 (3-D tiles) bit for bit with its plain version and with
    three one-channel B launches, in one launch of its own."""
    field, pos = _field3_operands(cuda, dims, kind)
    kernels.reset_launch_counts()
    got = kernels.warp_field3(field, pos, K)
    assert kernels.launch_counts == {k: int(k == "warp_field3") for k in kernels.launch_counts}
    assert torch.equal(got, kernels.warp_field3_plain(field, pos, K))
    by_channel = torch.cat([kernels.warp(field[c:c + 1], pos, K, (False,)) for c in range(3)])
    assert torch.equal(got, by_channel)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("K", [None, 2])
@pytest.mark.parametrize("floor", [(False,), (False, True), (False, True, False, True)])
def test_warp_forms_at_128_match_plain(cuda, floor, K, kind):
    """B's one-channel (3-D tiles, two voxels a thread), mixed two-channel
    (rows) and generic (C = 4) forms at the main path's 128^3: atol 1e-5 on
    the trilinear channels, bitwise on the floor ones, as on the small grids."""
    field, pos = _field3_operands(cuda, (128,) * 3, kind)
    vol = torch.cat([field, field[:1].floor()])[: len(floor)].contiguous()
    got = kernels.warp(vol, pos, K, floor)
    want = kernels.warp_plain(vol, pos, K, floor)
    for c, fl in enumerate(floor):
        if fl:
            assert torch.equal(got[c], want[c]), c
        else:
            torch.testing.assert_close(got[c], want[c], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_compositive_on_card_matches_golden(cuda):
    """tests/golden/solver_16_compositive.npz on the card (atol 1e-5): the
    exact T0 warp and composition, 32 increment iterations, the cold
    8-step inverse."""
    from sobfu_tpu_torch.tsdf import init_sphere

    dims, vs = (16, 16, 16), 0.25 / 16
    tg, wg = init_sphere(dims, (vs,) * 3, (0.125,) * 3, 0.04, 8 * vs, 3 * vs, device=cuda)
    tn, wn = init_sphere(dims, (vs,) * 3, (0.118, 0.125, 0.125), 0.04, 8 * vs, 3 * vs,
                         device=cuda)
    kernels.reset_launch_counts()
    res = solver.estimate_psi_compositive(
        fields.identity_field(dims, device=cuda), tg, wg, tn, wn,
        solver.sobolev_filter_1d(7, 0.1), 0.1, 0.3, 32, -1.0, warp_window=2, inverse_iters=8,
    )
    assert kernels.launch_counts["gd_iteration"] == 32
    assert kernels.launch_counts["warp_field3"] == 1
    g = np.load(os.path.join(ROOT, "tests", "golden", "solver_16_compositive.npz"))
    np.testing.assert_allclose(res.psi.cpu().numpy(), g["psi"], atol=1e-5)
    np.testing.assert_allclose(res.tsdf_n_psi.cpu().numpy(), g["tnp"], atol=1e-5)
    np.testing.assert_allclose(res.psi_inv.cpu().numpy(), g["psi_inv"], atol=1e-5)


@pytest.mark.cuda
def test_fine_window_pyramid_on_card_matches_cpu(cuda):
    """A pyramid with a compositive fine level (FINE_WINDOW=1) and the fused
    dispatch on a 16x16x128 grid: E on the 8x8x64 coarse level, A on the
    fine increment, F for the composition and C for the multigrid inverse;
    the result matches the same solve on the CPU."""
    dims = (16, 16, 128)
    rng = np.random.default_rng(5)
    tg = rng.standard_normal(dims).astype(np.float32) * 0.1
    tn = np.roll(tg, 1, axis=2)
    kw = dict(levels=2, warp_window=2, fine_window=1, momentum=0.95, inverse_iters=3,
              stall_window=16, stall_rel=1e-2, fused=True, inv_multigrid=True)
    taps = solver.sobolev_filter_1d(7, 0.1)

    def run(dev):
        t = [torch.as_tensor(a, device=dev) for a in (tg, tn)]
        return solver.estimate_psi_pyramid(
            fields.identity_field(dims, device=dev), t[0], t[0], t[1], t[1], taps, 0.05, 0.2,
            40, 1e-3, **kw,
        )

    kernels.reset_launch_counts()
    got = run(cuda)
    counts = dict(kernels.launch_counts)
    assert counts["gd_multi"] == got.coarse_iters // 16 > 0
    assert counts["gd_iteration"] == got.iters - got.coarse_iters
    assert counts["compose_weight"] == 1 and counts["inverse_fixed_point"] == 2
    want = run("cpu")
    assert (got.iters, got.coarse_iters) == (want.iters, want.coarse_iters)
    for field in ("psi", "psi_inv", "tsdf_n_psi", "weight_n_psi"):
        np.testing.assert_allclose(getattr(got, field).cpu().numpy(),
                                   getattr(want, field).numpy(), atol=1e-5, err_msg=field)


@pytest.mark.cuda
@pytest.mark.parametrize("K,momentum,with_energy", [(2, 0.95, True), (None, None, False),
                                                    (1, 0.9, True)])
def test_gd_iteration_scenes_kernel(cuda, K, momentum, with_energy):
    """A over three scenes, the middle one inactive, in one launch: within
    atol 1e-5 of the plain version; each active scene equal to an unbatched
    A launch bit for bit (norm and energy too); the inactive scene keeps
    its state and reports 0."""
    per = [_inputs(cuda, 1.5, seed=20 + s) for s in range(3)]
    b = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    taps = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1), device=cuda)
    active = torch.tensor([True, False, True], device=cuda)
    args = (b["psi"], b["tnp"], b["vel"], b["tg"], b["live"], taps, 0.05, 0.2, momentum, K,
            active)
    kernels.reset_launch_counts()
    got = kernels.gd_iteration_scenes(*args, with_energy=with_energy)
    assert kernels.launch_counts["gd_iteration_scenes"] == 1
    want = kernels.gd_iteration_scenes_plain(*args, with_energy=with_energy)
    for g, w in zip(got[:3], want[:3]):
        if w is not None:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    for g, w in zip(got[3:], want[3:]):
        torch.testing.assert_close(g, w, atol=0, rtol=1e-5)
    for s in (0, 2):
        one = kernels.gd_iteration(b["psi"][s], b["tnp"][s], b["vel"][s], b["tg"][s],
                                   b["live"][s], taps, 0.05, 0.2, momentum, K,
                                   with_energy=with_energy)
        for g, w in zip(got, one):
            if w is not None:
                assert torch.equal(g[s], w)
    assert torch.equal(got[0][1], b["psi"][1]) and torch.equal(got[1][1], b["tnp"][1])
    assert all(float(o[1]) == 0.0 for o in got[3:])


@pytest.mark.cuda
@pytest.mark.parametrize("fine_window", [None, 1])
def test_frame_step_on_card_matches_cpu(cuda, fine_window):
    """make_frame_step with the tool's windowed configuration (MAX_ITER 16)
    on two 16^3 scenes: equal iterations and fields within 1e-5 of the
    same step on the CPU; A runs as gd_iteration_scenes only; scene 0 of
    the batch equals scene 0 alone bit for bit."""
    from sobfu_tpu_torch.parallel import make_frame_step

    dims, S = (16, 16, 16), 2
    rng = np.random.default_rng(7)
    ident = fields.identity_field(dims).numpy()
    psi = np.stack([ident + rng.uniform(-0.3, 0.3, ident.shape) for _ in range(S)])
    tg = np.clip(rng.standard_normal((S,) + dims), -1, 1)
    dists = rng.uniform(0.35, 0.45, (S, 24, 32))
    v2c = np.tile(np.eye(4), (S, 1, 1))
    v2c[:, :3, 3] = (-0.125, -0.125, 0.2)
    vs = 0.25 / 16
    taps = solver.sobolev_filter_1d(7, 0.1)
    scalars = ((20.0, 20.0, 15.5, 11.5), (vs,) * 3, 8 * vs, 3 * vs, 64.0, taps, 0.1, 0.2, 16,
               1e-3)
    cfg = dict(inverse_iters=3, warp_window=2, fused=True, taps_static=tuple(taps),
               momentum=0.95, warm_inverse=True, pyramid_levels=2, stall_window=8,
               stall_rel=1e-2, fine_window=fine_window)

    def run(dev, s=slice(None)):
        step = make_frame_step(dims, device=dev, **cfg)
        t = [torch.as_tensor(a[s], dtype=torch.float32) for a in (psi, tg, np.abs(tg), dists)]
        return step(t[0], t[1], t[2], t[3], v2c[s], *scalars, t[0])

    kernels.reset_launch_counts()
    got = run(cuda)
    assert kernels.launch_counts["gd_iteration_scenes"] > 0
    assert kernels.launch_counts["gd_iteration"] == 0
    want = run("cpu")
    assert got[4].tolist() == want[4].tolist()
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-5)
    solo = run(cuda, slice(0, 1))
    for g, o in zip(got, solo):
        assert torch.equal(g[0].cpu(), o[0].cpu())


# ---------------------------------------------------------------------------
# the redesigned kernels: A in one launch, the chunked loop, B's variants
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(12, 16, 20), (16, 16, 16), (9, 11, 37), (40, 24, 72)])
@pytest.mark.parametrize("s,K,momentum", [(7, 2, 0.9), (3, None, None), (11, 1, 0.95),
                                          (5, 2, None), (9, None, 0.9), (1, 1, None)])
def test_gd_iteration_one_launch_matches_plain(cuda, dims, s, K, momentum):
    """A on grids under, at and over a tile's 8 x 32 extent (masked edges,
    several tiles and z segments), with every tap count: atol 1e-5 on the
    state, rtol 1e-5 on the norm and the energy."""
    d = _multi_inputs(cuda, dims)
    taps = torch.as_tensor(np.ones(1, np.float32) if s == 1 else solver.sobolev_filter_1d(s, 0.1),
                           device=cuda)
    args = (d["psi"], d["tnp"], d["vel"], d["tg"], d["live"], taps, 0.05, 0.2, momentum, K)
    got = kernels.gd_iteration(*args, with_energy=True)
    want = kernels.gd_iteration_plain(*args, with_energy=True)
    for g, w in zip(got[:3], want[:3]):
        if w is not None:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    torch.testing.assert_close(got[3], want[3], atol=0, rtol=1e-5)
    torch.testing.assert_close(got[4], want[4], atol=0, rtol=1e-5)


def _chained_on_card(b, taps, momentum, K, thresh, active, n, with_energy):
    """n gd_iteration_scenes launches with the stop rule decided on the host."""
    dev = b["psi"].device
    psi, tnp, vel = b["psi"], b["tnp"], b["vel"] if momentum is not None else None
    S = psi.shape[0]
    on = np.asarray(active, bool).copy()
    done, rows, e = np.zeros(S, np.int32), np.zeros((n, S), np.float32), None
    for k in range(n):
        if k:
            on &= np.sqrt(rows[k - 1]) > np.float32(thresh)
        if not on.any():
            break
        last = with_energy and k == n - 1
        out = kernels.gd_iteration_scenes(psi, tnp, vel, b["tg"], b["live"], taps, 0.05, 0.2,
                                          momentum, K, torch.as_tensor(on, device=dev), last)
        psi, tnp, vel = out[:3]
        rows[k] = out[3].cpu().numpy()
        done += on
        if last:
            e = out[4].cpu().numpy()
    return dict(b, psi=psi, tnp=tnp, vel=vel), done, rows, e


@pytest.mark.cuda
@pytest.mark.parametrize("momentum", [None, 0.5])
def test_gd_loop_chunks_bitwise_vs_single_launches(cuda, momentum):
    """kernels.GdLoop (16 iterations per call, the stop test on the card)
    against 16 single launches with the stop test on the host, bit for bit,
    over two chunks: three scenes, scene 1 frozen from the start, scene 2
    stopping inside the first chunk (so the scenes' results lie in different
    buffers of the ping-pong pair), the energy after each chunk; and the
    iteration, empty-launch and host-read counts."""
    dims, n, K = (12, 16, 40), 16, 2
    per = [_multi_inputs(cuda, dims, seed=30 + s) for s in range(3)]
    b = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    b["vel"] = torch.zeros_like(b["vel"])
    ident = fields.identity_field(dims, device=cuda)
    b["psi"][2] = ident + 0.3 * (b["psi"][2] - ident)
    taps = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1), device=cuda)
    active = np.array([True, False, True])
    _, _, rows, _ = _chained_on_card(b, taps, momentum, K, -1.0, active, n, False)
    norms = np.sqrt(rows[:, 2])
    j = max(k for k in range(13) if k == 0 or norms[k] < norms[:k].min())
    thresh = float(norms[j])
    kernels.reset_launch_counts()
    loop = kernels.GdLoop("gd_iteration_scenes", b["psi"], b["tnp"], b["tg"], b["live"], taps,
                          0.05, 0.2, momentum, K, thresh, energy=True)
    ref, total, ran = b, np.zeros(3, np.int64), 0
    for _ in range(2):
        done, rows, e = loop.run(n, active, with_energy=True)
        ran += int(done.max())
        ref, want_done, want_rows, want_e = _chained_on_card(ref, taps, momentum, K, thresh,
                                                             active, n, True)
        assert done.tolist() == want_done.tolist()
        np.testing.assert_array_equal(rows, want_rows)
        if want_e is not None:
            np.testing.assert_array_equal(e, want_e)
        psi, tnp, vel = loop.state()
        assert torch.equal(psi, ref["psi"]) and torch.equal(tnp, ref["tnp"])
        if momentum is not None:
            assert torch.equal(vel, ref["vel"])
        total += done
        active = active & (done == n)
    assert total[1] == 0 and total[2] == j + 1
    assert kernels.host_reads["gd_iteration_scenes"] == 2
    # the loop counts the iterations that ran, the reference one per launch
    assert kernels.launch_counts["gd_iteration_scenes"] == 2 * ran
    assert kernels.empty_launches["gd_iteration_scenes"] == 2 * n - ran


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 2])
@pytest.mark.parametrize("floor", [(False,), (True,), (False, False), (True, False),
                                   (False, True), (True, True), (False, False, False),
                                   (True, False, True), (False, True, True), (True, True, True),
                                   (False, True, False, True)])
def test_warp_variants_match_plain(cuda, K, floor):
    """B's compile-time variants (exact / window x C = 1, 2, 3 x floor masks)
    and the generic kernel (C = 4): atol 1e-5 on the trilinear channels,
    bitwise on the floor ones; on the parity grid and on one whose width is
    no multiple of 4."""
    for dims in (DIMS, (7, 9, 13)):
        rng = np.random.default_rng(41)
        ident = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")[::-1])
        psi = torch.as_tensor(ident + rng.uniform(-3.0, 3.0, (3,) + dims), dtype=torch.float32,
                              device=cuda)
        vol = torch.as_tensor(rng.integers(0, 5, (len(floor),) + dims), dtype=torch.float32,
                              device=cuda) * 0.25
        got = kernels.warp(vol, psi, K, floor)
        want = kernels.warp_plain(vol, psi, K, floor)
        for c, fl in enumerate(floor):
            if fl:
                assert torch.equal(got[c], want[c]), (dims, c)
            else:
                torch.testing.assert_close(got[c], want[c], atol=1e-5, rtol=0)


def _per_chunk_on_card(psi, tnp, tg, live, taps, K, max_iter, thresh, momentum, stall_window,
                       stall_rel, n=16):
    """Kernel E's loop as it was: one gd_multi launch a chunk, then the host
    reads its last norm (and its last energy at a check)."""
    vel = torch.zeros_like(psi) if momentum is not None else None
    thresh = float(np.float32(thresh))
    it, mnorm, e_ref, stalled, rows = 0, float("inf"), float("inf"), False, []
    while it < max_iter and mnorm > thresh and not stalled:
        it += n
        at_check = bool(stall_window) and it % stall_window == 0
        out = kernels.gd_multi(psi, tnp, vel, tg, live, taps, 0.05, 0.2, momentum, K, n,
                               with_energy=at_check)
        psi, tnp, vel = out.psi, out.tnp, out.vel
        rows.append(out.mx_sq.cpu().numpy())
        mnorm = float(np.sqrt(rows[-1][-1]))
        if at_check:
            stalled, e_ref = solver.stall_check(float(out.e_data[-1]), e_ref, it, stall_window,
                                                stall_rel)
    return psi, tnp, vel, it, mnorm, stalled


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["norm_stop", "cap_40", "cap_over_8_chunks", "stall_stop"])
def test_gd_multi_loop_bitwise_vs_per_chunk_launches(cuda, case):
    """kernels.GdMultiLoop (up to 8 launches per host read, the stop test on
    the card) against one E launch per chunk with the test on the host, bit
    for bit: state, velocity, iterations, last norm, the stall; and the
    launch, empty-launch and host-read counts."""
    dims, K = (16, 16, 64), 1
    d = _multi_inputs(cuda, dims, seed=40)
    taps = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1), device=cuda)
    max_iter, momentum, stall_window, stall_rel, thresh = 400, 0.95, 0, 0.0, -1.0
    if case == "norm_stop":  # the third chunk's last norm: a stop by then
        out = kernels.gd_multi(d["psi"], d["tnp"], torch.zeros_like(d["psi"]), d["tg"], d["live"],
                               taps, 0.05, 0.2, momentum, K, 48)
        thresh = float(np.sqrt(out.mx_sq.cpu().numpy()[47]))
    elif case == "cap_40":
        max_iter = 40
    elif case == "cap_over_8_chunks":
        max_iter, momentum = 200, None
    else:
        stall_window, stall_rel = 16, 1.0
    want = _per_chunk_on_card(d["psi"], d["tnp"], d["tg"], d["live"], taps, K, max_iter, thresh,
                              momentum, stall_window, stall_rel)
    kernels.reset_launch_counts()
    loop = kernels.GdMultiLoop(d["psi"], d["tnp"], d["tg"], d["live"], taps, 0.05, 0.2,
                               momentum, K, thresh, max_iter, 16, stall_window, stall_rel)
    reads = 0
    while loop.running:
        loop.run(min(kernels.GD_MULTI_LAUNCHES, -(-(max_iter - loop.count) // 16)))
        reads += 1
    psi, tnp, vel = loop.state()
    assert (loop.count, loop.mnorm, loop.stalled) == want[3:]
    assert torch.equal(psi, want[0]) and torch.equal(tnp, want[1])
    if momentum is not None:
        assert torch.equal(vel, want[2])
    chunks = loop.count // 16
    assert kernels.launch_counts["gd_multi"] == chunks
    assert kernels.host_reads["gd_multi"] == reads == -(-chunks // kernels.GD_MULTI_LAUNCHES)
    if case == "norm_stop":
        assert chunks <= 3 and kernels.empty_launches["gd_multi"] == 8 - chunks
    if case.startswith("cap"):
        assert loop.count == -(-max_iter // 16) * 16
    if case == "stall_stop":
        assert loop.stalled and loop.count < max_iter


@pytest.mark.cuda
@pytest.mark.parametrize("dims,K,iters,warm", [((128,) * 3, 2, 3, True), ((64,) * 3, 1, 3, True),
                                               ((128,) * 3, None, 48, False)])
def test_inverse_kernel_at_the_main_paths_shapes(cuda, dims, K, iters, warm):
    """C at the slice's (128^3, K=2, 3 warm steps), the multigrid coarse
    inverse's (64^3, K=1, 3 warm steps) and the shipped ini's (128^3, 48
    exact steps from the identity) shapes: atol 1e-5 against its plain
    version (the corners' psi - index is the plain version's subtraction)."""
    rng = np.random.default_rng(9)
    ident = fields.identity_field(dims, device=cuda)
    psi = ident + torch.as_tensor(rng.uniform(-0.9, 0.9, (3,) + dims), dtype=torch.float32,
                                  device=cuda)
    init = kernels.inverse_fixed_point_plain(psi, 2, K if K is not None else 2) if warm else None
    got = kernels.inverse_fixed_point(psi, iters, K, init)
    want = kernels.inverse_fixed_point_plain(psi, iters, K, init)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _scene_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_scene", os.path.join(ROOT, "tools", "make_synthetic_scene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pipeline_params(dim, **extra):
    from sobfu_tpu_torch.config import Intr, Params, translation_pose

    p = Params()
    p.volume_dims, p.volume_size = (dim,) * 3, (0.4, 0.4, 0.4)
    p.volume_pose = translation_pose((-0.2, -0.2, 0.25))
    p.intr = Intr(60.0, 60.0, 31.5, 23.5)
    p.tsdf_trunc_dist, p.eta = 6.0 * 0.4 / dim, 3.0 * 0.4 / dim
    p.bilateral_kernel_size, p.start_frame = 5, 1
    p.max_iter, p.max_update_norm, p.alpha, p.w_reg, p.warp_window = 16, 1e-6, 0.1, 0.2, 2
    for k, v in extra.items():
        setattr(p, k, v)
    return p


# the single-level window slice at 32^3, and the pyramid's no-log loop with
# the half-res inverse carry at 64^3 (E on the 32^3 coarse level)
CHECKPOINT_CASES = [
    (32, {}),
    (64, dict(pyramid_levels=2, momentum=0.95, alpha=0.05, max_iter=64, max_update_norm=4e-3,
              stall_window=16, stall_rel=1e-2, inv_coarse=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dim,extra", CHECKPOINT_CASES, ids=["32", "64-half-res"])
def test_checkpoint_resume_bitwise_on_card(cuda, tmp_path, dim, extra):
    """SobFusion on the card: 3 frames + save + load + 3 frames equal 6
    straight, every key of the checkpoint bit for bit."""
    from sobfu_tpu_torch.pipeline import SobFusion
    from sobfu_tpu_torch.utils import checkpoint

    render = _scene_tool().render_prims_depth
    frames = [render(48, 64, 60.0, 60.0, 31.5, 23.5, [((0.005 * i, 0.0, 0.45), 0.08)])
              for i in range(6)]
    params = _pipeline_params(dim, **extra)
    runs = [SobFusion(params, device="cuda") for _ in range(3)]
    for f in runs:
        f.need_inv_warps = False
    straight, first, resumed = runs
    for d in frames:
        straight(d)
    for d in frames[:3]:
        first(d)
    path = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(path, first)
    checkpoint.load_checkpoint(path, resumed)
    assert resumed.psi.data.device.type == "cuda"
    for d in frames[3:]:
        resumed(d)
    a, b = checkpoint.state_dict(straight), checkpoint.state_dict(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    half = (3,) + (dim // 2,) * 3
    assert (a["psi_inv"].shape == half) == ("inv_coarse" in extra)


@pytest.mark.cuda
def test_cli_checkpoint_resume_on_card(cuda, tmp_path, capsys):
    """python -m sobfu_tpu_torch ... --device cuda --checkpoint / --resume:
    2 + resume + 2 frames give the checkpoint of 4 straight, bit for bit."""
    from sobfu_tpu_torch import cli

    scene = tmp_path / "scene"
    _scene_tool().main([str(scene), "--frames", "4", "--dim", "32", "--width", "64",
                        "--height", "48"])
    ini = str(scene / "params.ini")
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    base = [str(scene), ini, "--device", "cuda", "--enable-log", "--checkpoint"]
    assert cli.main(base + [a]) == 0
    assert cli.main(base + [b, "--max-frames", "2"]) == 0
    capsys.readouterr()
    assert cli.main(base + [b, "--resume", b]) == 0
    assert "resumed at frame 2" in capsys.readouterr().out
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        assert all(x[k].tobytes() == y[k].tobytes() for k in x.files)


def _slab_operands(d, n_z, K):
    """Each z-slab's operands of kernel A's slab form, cut from whole-volume
    operands d (a scene axis in front) by the halo exchange."""
    from sobfu_tpu_torch.parallel import zshard

    devs = [d["psi"].device] * n_z
    pad = {k: zshard._halo_exchange_z(zshard._split(d[k][None], devs), zshard.H)
           for k in ("psi", "tnp", "vel", "tg", "live")}
    Zl = d["tg"].shape[0] // n_z
    return [((pad["psi"][j], pad["tnp"][j], pad["vel"][j], pad["tg"][j],
              d["live"][None] if K is None else pad["live"][j]),
             j * Zl, 0 if K is None else j * Zl - zshard.H) for j in range(n_z)]


SLAB_CASES = [((12, 16, 20), 2, 2, 7, 0.9), ((64, 64, 64), 4, None, 7, 0.95),
              ((64, 64, 64), 4, 1, 5, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims,n_z,K,s,momentum", SLAB_CASES)
def test_gd_slab_kernel_matches_whole_volume_launch(cuda, dims, n_z, K, s, momentum):
    """Kernel A's slab form on each of n_z slabs equals the whole-volume A
    launch bit for bit (psi', tnp', vel' of the slab's rows; the max norm
    over the slabs) and its plain version within atol 1e-5."""
    rng = np.random.default_rng(7)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in dims], indexing="ij")[::-1])
    d = {k: torch.as_tensor(v, dtype=torch.float32, device=cuda) for k, v in dict(
        psi=ident + rng.uniform(-1.8 if K else -3.5, 1.8 if K else 3.5, (3,) + dims),
        tnp=0.3 * rng.standard_normal(dims), vel=0.1 * rng.standard_normal((3,) + dims),
        tg=0.3 * rng.standard_normal(dims), live=0.3 * rng.standard_normal(dims)).items()}
    taps = torch.as_tensor(solver.sobolev_filter_1d(s, 0.1), device=cuda)
    whole = kernels.gd_iteration(d["psi"], d["tnp"], d["vel"], d["tg"], d["live"], taps, 0.05,
                                 0.2, momentum, K)
    Zl = dims[0] // n_z
    mx = []
    for args, zb, lz0 in _slab_operands(d, n_z, K):
        got = kernels.gd_iteration_slab(*args, taps, 0.05, 0.2, momentum, K, zb, dims[0], lz0)
        want = kernels.gd_iteration_slab_plain(*args, taps, 0.05, 0.2, momentum, K, zb, dims[0],
                                               lz0)
        rows = slice(zb, zb + Zl)
        assert torch.equal(got[0][0], whole[0][:, rows]) and torch.equal(got[1][0], whole[1][rows])
        if momentum is not None:
            assert torch.equal(got[2][0], whole[2][:, rows])
        for g, w in zip(got[:3], want[:3]):
            if w is not None:
                torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
        mx.append(float(got[3][0]))
    assert max(mx) == float(whole[3])


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["card", "slab"])
@pytest.mark.parametrize("n_z", [2, 4, 8])
def test_gd_slab_loop_on_card_equals_whole_volume_loop(cuda, n_z, split, monkeypatch):
    """kernels.GdSlabLoop over n_z slabs of one card against kernels.GdLoop
    on the whole 32^3 volume: a norm stop inside a chunk of 16; the
    iterations, the norm rows and psi, tnp and vel bit for bit, one host
    read. split "card": the slabs are one card group (one call of 16
    launches, the neighbours' rows read in place); "slab": card_groups
    patched to one group a slab (a launch per group and iteration, the halo
    rows and the stop test's norm words between groups). Launches are
    counted per group launch that ran, the rest as empty."""
    from sobfu_tpu_torch.parallel import zshard

    rng = np.random.default_rng(8)
    dims = (32, 32, 32)
    ident = np.stack(np.meshgrid(*[np.arange(n) for n in dims], indexing="ij")[::-1])
    d = {k: torch.as_tensor(v, dtype=torch.float32, device=cuda)[None] for k, v in dict(
        psi=ident + rng.uniform(-1.0, 1.0, (3,) + dims), tnp=0.3 * rng.standard_normal(dims),
        tg=0.3 * rng.standard_normal(dims), live=0.3 * rng.standard_normal(dims)).items()}
    taps = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1), device=cuda)
    on = np.ones(1, bool)
    probe = kernels.GdLoop("gd_iteration_scenes", d["psi"], d["tnp"], d["tg"], d["live"], taps,
                           0.05, 0.2, 0.9, 2, -1.0)
    norms = np.sqrt(probe.run(16, on)[1][:, 0])
    j = max(k for k in range(12) if k == 0 or norms[k] < norms[:k].min())
    whole = kernels.GdLoop("gd_iteration_scenes", d["psi"], d["tnp"], d["tg"], d["live"], taps,
                           0.05, 0.2, 0.9, 2, float(norms[j]))
    want = whole.run(16, on)
    groups = 1
    if split == "slab":
        groups = n_z
        monkeypatch.setattr(kernels, "card_groups", lambda devs: [(i, i + 1) for i in range(n_z)])
    devs = [cuda] * n_z
    loop = kernels.GdSlabLoop(
        zshard._split(d["psi"], devs), zshard._split(d["tnp"], devs),
        zshard._halo_exchange_z(zshard._split(d["tg"], devs), zshard.H),
        zshard._halo_exchange_z(zshard._split(d["live"], devs), zshard.H), taps, 0.05, 0.2, 0.9,
        2, float(norms[j]), dims[0])
    assert len(loop.groups) == groups
    kernels.reset_launch_counts()
    got = loop.run(16, on)
    assert int(got[0][0]) == j + 1 and got[0].tolist() == want[0].tolist()
    assert np.array_equal(got[1], want[1])
    for k, w in enumerate(whole.state()):
        assert torch.equal(torch.cat([s[k] for s in loop.state()], dim=-3), w)
    assert kernels.host_reads["gd_iteration_slab"] == 1
    assert loop.calls == (1 if groups == 1 else 16 * groups)
    assert kernels.launch_counts["gd_iteration_slab"] == groups * (j + 1)
    assert kernels.empty_launches["gd_iteration_slab"] == groups * (16 - j - 1)


@pytest.mark.cuda
def test_sharded_solve_on_card_matches_the_cpu(cuda):
    """make_sharded_estimate_psi on 4 slabs of one card (fused: kernel A's
    slab form) against the same solve on 4 CPU devices (its plain version):
    equal iterations, every output within 1e-5."""
    from sobfu_tpu_torch.parallel import make_mesh, make_sharded_estimate_psi
    from sobfu_tpu_torch.tsdf import init_sphere

    dims, vs = (32, 32, 32), 0.125 / 32
    tg, wg = init_sphere(dims, (vs,) * 3, (0.0625,) * 3, 0.01, 10 * vs, 2 * vs)
    tn, wn = init_sphere(dims, (vs,) * 3, (0.0625 - 1.5 * vs, 0.0625, 0.0625), 0.01, 10 * vs,
                         2 * vs)
    taps = solver.sobolev_filter_1d(7, 0.1)
    opts = dict(inverse_iters=4, warp_window=2, fused=True, taps_static=tuple(taps),
                momentum=0.9, stall_window=8, stall_rel=1e-2)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        fn = make_sharded_estimate_psi(make_mesh(n_z=4, devices=[dev] * 4), **opts)
        outs.append(fn(fields.identity_field(dims), tg, wg, tn, wn, taps, 0.1, 0.4, 40, -1.0))
    got, want = outs
    assert int(got[6]) == int(want[6])
    for g, w in zip(got[:6], want[:6]):
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=0)


@pytest.fixture
def cards(cuda):
    """Up to four distinct cards; skips with fewer than two."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    return [torch.device("cuda", i) for i in range(min(n, 4))]


def _same(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("per_card", [1, 2])
@pytest.mark.parametrize("warp_window", [2, None])
def test_sharded_solve_on_distinct_cards_equals_one_card(cards, warp_window, per_card):
    """make_sharded_estimate_psi with per_card consecutive z-slabs on each
    card (one card group a card: the halo rows, the stop test's norm words
    and the energies copied between cards) equals the same mesh laid on one
    card (one group) bit for bit: windowed (fused, momentum, warm inverse, a
    stall stop) and exact (gathered volumes)."""
    from sobfu_tpu_torch.parallel import make_mesh, make_sharded_estimate_psi
    from sobfu_tpu_torch.tsdf import init_sphere

    devs = [c for c in cards for _ in range(per_card)]
    n = len(devs)
    dims, vs = (16 * n, 32, 32), 0.125 / 32
    c = (0.0625, 0.0625, 0.0625 * n)
    tg, wg = init_sphere(dims, (vs,) * 3, c, 0.02, 10 * vs, 2 * vs)
    tn, wn = init_sphere(dims, (vs,) * 3, (c[0] - 1.5 * vs, c[1], c[2]), 0.02, 10 * vs, 2 * vs)
    taps = solver.sobolev_filter_1d(7, 0.1)
    psi = fields.identity_field(dims)
    if warp_window is None:
        opts, extra = dict(inverse_iters=4), ()
    else:
        opts = dict(inverse_iters=4, warp_window=2, fused=True, taps_static=tuple(taps),
                    momentum=0.9, warm_inverse=True, stall_window=8, stall_rel=0.2)
        extra = (psi + 0.1,)
    outs = []
    for layout in (devs, [cards[0]] * n):
        mesh = make_mesh(n_z=n, devices=layout)
        fn = make_sharded_estimate_psi(mesh, **opts)
        outs.append((fn(psi, tg, wg, tn, wn, taps, 0.1, 0.4, 40, -1.0, *extra), mesh.gathers))
    (got, g_gathers), (want, w_gathers) = outs
    assert int(got[6]) == int(want[6]) and g_gathers == w_gathers
    assert _same(got[:6], want[:6]) and float(got[7]) == float(want[7])
    if warp_window is not None:
        assert int(got[6]) < 40  # the stall stop fired


def _drifting_frames(meshes, n):
    """make_frame_step over each (1 scene x n z) mesh of ``meshes``, two
    scenes of drifting spheres batched on A's slab form (the slab form's
    plain version on CPU devices), two carried frames at MAX_ITER 24 (the
    pyramid, the stall stop). Returns each mesh's two frame outputs."""
    from sobfu_tpu_torch.parallel import make_frame_step
    from sobfu_tpu_torch.tsdf import init_sphere

    dims, vs = (16 * n, 32, 32), 0.25 / 32
    taps = solver.sobolev_filter_1d(7, 0.1)
    cfg = dict(inverse_iters=3, warp_window=2, fused=True, taps_static=tuple(taps),
               momentum=0.95, warm_inverse=True, pyramid_levels=2, stall_window=8,
               stall_rel=1e-2)
    tg, wg = init_sphere(dims, (vs,) * 3, (0.125, 0.125, 0.0625 * n), 0.06, 8 * vs, 3 * vs)
    psi = fields.identity_field(dims)
    state = (torch.stack([psi] * 2), torch.stack([tg] * 2), torch.stack([wg] * 2),
             torch.stack([psi] * 2))
    H, W = 48, 64
    uu = np.arange(W, dtype=np.float32)[None, :] / W
    frames = [np.stack([0.28 + 0.08 * uu * np.ones((H, 1), np.float32) + 0.004 * i * s
                        for s in (1, -1)]) for i in (1, 2)]
    v2c = np.eye(4, dtype=np.float32)
    v2c[:3, 3] = (-0.125, -0.125, 0.2)
    scalars = ((40.0, 40.0, W / 2, H / 2), (vs,) * 3, 8 * vs, 3 * vs, 64.0, taps, 0.1, 0.2, 24,
               1e-3)
    runs = []
    for mesh in meshes:
        step = make_frame_step(dims, mesh=mesh, **cfg)
        st, outs = state, []
        for d in frames:
            out = step(*st[:3], d, np.stack([v2c] * 2), *scalars, st[3])
            outs.append(out)
            st = (out[0], out[2], out[3], out[1])
        runs.append(outs)
    return runs


@pytest.mark.cuda
def test_frame_step_on_distinct_cards_equals_one_card(cards):
    """make_frame_step over a (1 scene x n z) mesh of distinct cards and over
    the same mesh on one card (_drifting_frames): equal bit for bit."""
    from sobfu_tpu_torch.parallel import make_mesh

    n = len(cards)
    runs = _drifting_frames([make_mesh(n_z=n, devices=devs) for devs in (cards, [cards[0]] * n)],
                            n)
    for got, want in zip(*runs):
        assert got[4].tolist() == want[4].tolist()
        assert _same(got[:4], want[:4]) and torch.equal(got[5], want[5])


@pytest.mark.cuda
def test_frame_step_on_card_matches_the_cpu(cuda):
    """make_frame_step over a (1 scene x 4 z) mesh of one card (kernel A's
    slab form) against the same mesh on CPU devices (its plain version), in
    the configuration of _drifting_frames (the sharded pyramid and its
    seams, the stall stop): equal iterations; psi and psi_inv, which hold
    absolute coordinates, within 8 ulps of the largest (the pyramid's
    resamples sum in another order on the card), tsdf and weight within
    1e-5."""
    from sobfu_tpu_torch.parallel import make_mesh

    runs = _drifting_frames([make_mesh(n_z=4, devices=[dev] * 4)
                             for dev in (cuda, torch.device("cpu"))], 4)
    ulps = 8 * float(np.spacing(np.float32(63)))  # the (64, 32, 32) grid's largest coordinate
    for got, want in zip(*runs):
        assert got[4].tolist() == want[4].tolist()
        for g, w, tol in zip(got[:4], want[:4], (ulps, ulps, 1e-5, 1e-5)):
            torch.testing.assert_close(g.cpu(), w, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the rigid path (KinFu, raycast): plain torch on the card against the CPU
# ---------------------------------------------------------------------------

RIGID_SPHERES = (((0.0, 0.0, 1.5), 0.3), ((0.45, -0.3, 1.9), 0.15), ((-0.5, 0.35, 1.7), 0.12))


def _rigid_frames(n_frames, p):
    """chip_smoke.py's kinfu scene (tools/render_rigid_scene.py) at p's size."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "render_rigid_scene", os.path.join(ROOT, "tools", "render_rigid_scene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    poses = mod.trajectory(n_frames, 0.005, 0.2)
    return poses, [mod.render_depth(T, p.rows, p.cols, p.intr, spheres=RIGID_SPHERES, wall_z=2.5)
                   for T in poses]


def _small_kinfu_params(model):
    """KinFuParams.default_params() at 160 x 120 and 128^3 (the same 3 m)."""
    from sobfu_tpu_torch.config import Intr
    from sobfu_tpu_torch.kinfu import KinFuParams

    p = KinFuParams.default_params()
    p.cols, p.rows = 160, 120
    p.intr = Intr(131.25, 131.25, 79.5, 59.5)
    p.volume_dims = (128, 128, 128)
    p.track_against_model = model
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("model", [False, True], ids=["frame-to-frame", "frame-to-model"])
def test_kinfu_on_card_matches_the_cpu(cuda, model):
    """KinFu on the card and on the CPU over 4 frames of the moving camera:
    every frame tracks in both, poses within 1e-5; the tsdf within 1e-5 but
    on voxels whose projection lands on another pixel (the card contracts
    the projection's multiply-adds), at most 0.1% of the observed ones."""
    from sobfu_tpu_torch.kinfu import KinFu

    p = _small_kinfu_params(model)
    _, frames = _rigid_frames(4, p)
    card, cpu = KinFu(p), KinFu(p, device="cpu")
    assert card.tsdf().tsdf.device.type == "cuda"
    for d in frames:
        assert card(d) and cpu(d)
        np.testing.assert_allclose(card.get_camera_pose(), cpu.get_camera_pose(), atol=1e-5,
                                   rtol=0)
    seen = cpu.tsdf().weight > 0
    far = (card.tsdf().tsdf.cpu() - cpu.tsdf().tsdf).abs() > 1e-5
    assert int(seen.sum()) > 10000
    assert int((far & seen).sum()) <= 1e-3 * int(seen.sum())


@pytest.mark.cuda
def test_raycast_on_card_matches_the_cpu(cuda):
    """raycast_volume of a fused KinFu volume (CPU) on the card against the
    CPU, from a pose off the integrating one: the same hit mask; depth and
    points within 1e-5, normals within 1e-5."""
    from sobfu_tpu_torch.kinfu import KinFu
    from sobfu_tpu_torch.raycast import raycast_volume
    from sobfu_tpu_torch.tsdf import TsdfVolume

    p = _small_kinfu_params(False)
    poses, frames = _rigid_frames(2, p)
    kf = KinFu(p, device="cpu")
    for d in frames:
        assert kf(d)
    vol = kf.tsdf()
    card = TsdfVolume(_vol_params(p), device=cuda)
    card.tsdf, card.weight = vol.tsdf.to(cuda), vol.weight.to(cuda)
    pose = poses[1].astype(np.float32)
    got = raycast_volume(card, pose, p.intr, p.rows, p.cols, p.raycast_step_factor)
    want = raycast_volume(vol, pose, p.intr, p.rows, p.cols, p.raycast_step_factor)
    assert int((want[0] > 0).sum()) > 0.5 * p.rows * p.cols
    assert torch.equal(got[0].cpu() > 0, want[0] > 0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=0)


def _vol_params(p):
    """The TsdfVolume parameters KinFu builds from its KinFuParams."""
    from sobfu_tpu_torch.config import Params

    return Params(cols=p.cols, rows=p.rows, volume_dims=p.volume_dims, volume_size=p.volume_size,
                  volume_pose=p.volume_pose, intr=p.intr, tsdf_trunc_dist=p.tsdf_trunc_dist,
                  eta=p.tsdf_trunc_dist, tsdf_max_weight=p.tsdf_max_weight)


@pytest.mark.cuda
@pytest.mark.parametrize("production", [False, True], ids=["additive", "production"])
def test_fidelity_scene_on_card_matches_the_cpu(cuda, production):
    """tools/fidelity_torch.py's sphere translation at 32^3 (the JAX CI
    lanes' warp windows: 4 additive, 2 production; 128 iterations) on the
    card against the same scene on the CPU: the same iterations; the energy
    ratio, the mesh RMSE and the psi o psi_inv residual within 1e-4."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fidelity_port", os.path.join(ROOT, "tools", "fidelity_torch.py"))
    fid = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fid)
    ww = 2 if production else 4
    got, want = (fid.scenario_sphere_translation(32, 128, ww, fid.Lane(dev, production))
                 for dev in (cuda, torch.device("cpu")))
    assert got["iters_run"] == want["iters_run"]
    for key in ("energy_ratio", "mesh_rmse_voxels", "inverse_consistency_max_vox"):
        assert got[key] == pytest.approx(want[key], abs=1e-4, rel=0), key


# ---------------------------------------------------------------------------
# the front end: kernels P (frontend.preprocess_depth) and I
# (frontend.integrate_dists), each against its plain version on the card
# ---------------------------------------------------------------------------

# params/params_umbrella.ini: the bilateral window's sigmas, TRUNC_DEPTH and
# the intrinsics of its 640x480 camera
FRONT_SIGMAS, FRONT_TRUNC, FRONT_INTR = (4.5, 0.04), 1.5, (570.342, 570.342, 320.0, 240.0)


def _frontend_depth(H, W, seed=0):
    """int32 mm: a 0.2 m sphere 0.8 m away before a wall at 1.6 m (past the
    truncation), 1.5 mm of noise and 3% holes."""
    from sobfu_tpu_torch.config import Intr

    intr = Intr(*FRONT_INTR)
    d = _scene_tool().render_prims_depth(H, W, *intr, [((0.02, -0.01, 0.8), 0.2)])
    d = np.where(d > 0, d, 1600).astype(np.float64)
    rng = np.random.default_rng(seed)
    d += rng.normal(0.0, 1.5, d.shape)
    d[rng.random(d.shape) < 0.03] = 0.0
    return np.clip(np.round(d), 0, 65535).astype(np.int32)


def _frontend_counts():
    from sobfu_tpu_torch.ops import frontend

    return dict(frontend.launch_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,k,trunc", [(480, 640, 7, FRONT_TRUNC), (480, 640, 7, 0.0),
                                         (480, 640, 5, FRONT_TRUNC), (480, 640, 3, 0.0),
                                         (479, 637, 7, FRONT_TRUNC)])
def test_frontend_preprocess_kernel_bitwise(cuda, H, W, k, trunc):
    """Kernel P bit for bit with the plain chain (bilateral filter, the
    truncation, the ray lengths) at the camera's 640x480 and an odd size."""
    from sobfu_tpu_torch.ops import frontend

    depth = torch.as_tensor(_frontend_depth(H, W), device=cuda)
    args = (depth, k, *FRONT_SIGMAS, trunc, FRONT_INTR)
    before = _frontend_counts()
    got = frontend.preprocess_depth(*args)
    assert _frontend_counts()["preprocess_depth"] == before["preprocess_depth"] + 1
    want = frontend.preprocess_depth_plain(*args)
    assert got.dtype == torch.float32 and got.shape == (H, W)
    assert torch.equal(got, want), int((got != want).sum())


def _frontend_volume(cuda, dim, z_offset=0, n_z=None, rotate_deg=0.0, size=1.0):
    """The ini's 128^3 volume of 1 m (or ``size``) at (-size / 2, -size / 2,
    0.3) seen from the identity pose (optionally turned about y and x), a
    random previous (tsdf, weight) and the dists map of
    :func:`_frontend_depth`: the arguments of frontend.integrate_dists."""
    from sobfu_tpu_torch.ops import frontend

    rng = np.random.default_rng(7)
    nz = dim if n_z is None else n_z
    tsdf = torch.as_tensor(rng.uniform(-1, 1, (nz, dim, dim)), dtype=torch.float32, device=cuda)
    weight = torch.as_tensor(rng.integers(0, 4, (nz, dim, dim)), dtype=torch.float32,
                             device=cuda)
    depth = torch.as_tensor(_frontend_depth(480, 640, seed=3), device=cuda)
    dists = frontend.preprocess_depth_plain(depth, 7, *FRONT_SIGMAS, FRONT_TRUNC, FRONT_INTR)
    vol2cam = np.eye(4, dtype=np.float32)
    vol2cam[:3, 3] = (-0.5 * size, -0.5 * size, 0.3)
    if rotate_deg:
        a, b = np.deg2rad(rotate_deg), np.deg2rad(0.5 * rotate_deg)
        ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
        vol2cam[:3, :3] = (ry @ rx).astype(np.float32)
    vs = size / dim
    return (tsdf, weight, dists, vol2cam, FRONT_INTR, (vs, vs, vs), 8 * vs, 3 * vs,
            not rotate_deg, z_offset)


def _integrate_both(args):
    from sobfu_tpu_torch.ops import frontend

    before = _frontend_counts()
    got = frontend.integrate_dists(*args)
    assert _frontend_counts()["integrate_dists"] == before["integrate_dists"] + 1
    return got, frontend.integrate_dists_plain(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("z_offset,n_z,size", [(0, None, 1.0), (64, 32, 1.0), (0, None, 1.2)],
                         ids=["volume", "z-slab", "1.2m"])
def test_frontend_integrate_kernel_bitwise_axis_aligned(cuda, z_offset, n_z, size):
    """Kernel I on the axis-aligned branch at 128^3 (the cell's pose), on a
    z-slab of 32 rows at z_offset 64, and over 1.2 m (a voxel size that is no
    power of two, so addcmul's single rounding shows), bit for bit with its
    plain version; the voxels the frame does not see keep their values."""
    args = _frontend_volume(cuda, 128, z_offset, n_z, size=size)
    (t, w), (pt, pw) = _integrate_both(args)
    assert torch.equal(t, pt) and torch.equal(w, pw)
    assert int((w != args[1]).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("z_offset,n_z", [(0, None), (64, 32)], ids=["volume", "z-slab"])
def test_frontend_integrate_kernel_rotated_pose(cuda, z_offset, n_z):
    """Kernel I on the general branch (a pose turned 4 degrees about y and 2
    about x) against its plain version, whose einsum sums in cuBLAS's order:
    a voxel whose centre projects across a pixel edge reads another pixel
    and moves by the dists' step there (over 1e-4 here); at most 64 such
    voxels in 2M, and the rest within 1e-6 with equal weights."""
    (t, w), (pt, pw) = _integrate_both(_frontend_volume(cuda, 128, z_offset, n_z, 4.0))
    err = (t - pt).abs()
    moved = (err > 1e-4) | (w != pw)
    assert int(moved.sum()) <= 64
    assert float(err[~moved].max()) <= 1e-6


@pytest.mark.cuda
def test_frontend_wrappers_validate_and_route(cuda):
    """P takes int32 depth and I float32 volumes, else they raise; the frame
    loop's preprocess and integration reach the kernels, counted in
    frontend.launch_counts and not in kernels.launch_counts."""
    from sobfu_tpu_torch import pipeline
    from sobfu_tpu_torch.config import load_params
    from sobfu_tpu_torch.ops import frontend

    depth = torch.as_tensor(_frontend_depth(480, 640), device=cuda)
    with pytest.raises(TypeError):
        frontend.preprocess_depth(depth.float(), 7, *FRONT_SIGMAS, FRONT_TRUNC, FRONT_INTR)
    args = list(_frontend_volume(cuda, 32))
    args[0] = args[0].double()
    with pytest.raises(TypeError):
        frontend.integrate_dists(*args)
    kernels.reset_launch_counts()
    frontend.reset_launch_counts()
    fusion = pipeline.SobFusion(load_params(os.path.join(ROOT, "params", "params_umbrella.ini")),
                                device="cuda")
    fusion(depth)
    torch.cuda.synchronize()
    assert frontend.launch_counts == {"preprocess_depth": 1, "integrate_dists": 1}
    assert set(kernels.launch_counts) == set(kernels.KERNELS)
    assert float(fusion.phi_global.weight.sum()) > 1000
