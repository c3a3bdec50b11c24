"""The z-sharded solve and frame step (sobfu_tpu_torch.parallel.zshard)
against sobfu_tpu.parallel.sharding on the JAX CPU backend's 8 virtual
devices (tests/conftest.py); the port runs on make_mesh(devices=["cpu"] * n).

Kernel A's slab form is held through its plain version
(kernels.gd_iteration_slab_plain): to JAX's fused_gd_iteration_db_padded
slab contract (z_base / z_global, interpret mode) within 1e-5, and to the
whole-volume step bit for bit. The JAX references of the solves run the
XLA path (JAX's own tests hold its fused per-shard kernel to it within
2e-5); the port runs each both ways where it has both, its fused path on
the slab form. Solves and frame steps: equal iteration counts, psi and tnp
within 2e-5 (the figure of tests/test_sharding.py), psi_inv within 1e-4,
the floor-warped weights exact. 32^3 on 4 z-slabs, the frame step at (32,
16, 16) on a (2 scene x 2 z) mesh.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sobfu_tpu import fields as jf
from sobfu_tpu import solver as js
from sobfu_tpu.ops.pallas_kernels import fused_gd_iteration_db_padded
from sobfu_tpu.parallel import make_mesh as j_make_mesh
from sobfu_tpu.parallel import sharding as jsh
from sobfu_tpu.tsdf import init_sphere as j_init_sphere
from sobfu_tpu.tsdf import integrate_dists as j_integrate
from sobfu_tpu_torch import tsdf
from sobfu_tpu_torch.ops import kernels
from sobfu_tpu_torch.parallel import make_frame_step, make_mesh, make_sharded_estimate_psi
from sobfu_tpu_torch.parallel import sharding, zshard

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, SIZE = 32, 0.125
TAPS = js.sobolev_filter_1d(7, 0.1)
TAPS_STATIC = tuple(float(t) for t in TAPS)
H = kernels.SLAB_HALO


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _scene(shift):
    """tests/test_sharding.py's scene: a sphere and the same sphere moved
    along -x by shift (metres), 32^3."""
    dims, vs = (DIM,) * 3, SIZE / DIM
    c = SIZE / 2
    tg, wg = j_init_sphere(dims, (vs,) * 3, (c, c, c), 0.01, 10 * vs, 2 * vs)
    tn, wn = j_init_sphere(dims, (vs,) * 3, (c - shift, c, c), 0.01, 10 * vs, 2 * vs)
    return [np.asarray(a) for a in (tg, wg, tn, wn)]


def _random_slab_inputs(dims, seed=0, amp=1.5):
    rng = np.random.default_rng(seed)
    ident = np.asarray(jf.identity_field(dims))
    return dict(
        psi=(ident + rng.uniform(-amp, amp, (3,) + dims)).astype(np.float32),
        tnp=rng.standard_normal(dims).astype(np.float32),
        vel=rng.standard_normal((3,) + dims).astype(np.float32),
        tg=rng.standard_normal(dims).astype(np.float32),
        live=rng.standard_normal(dims).astype(np.float32),
    )


def _slab(a, z_base, Zl, h=H):
    """Rows [z_base - h, z_base + Zl + h) of a (axis -3), clamped into it:
    a slab with its halo as the exchange fills it (the rows past the
    volume's ends, which the slab form never reads, edge replicas)."""
    rows = np.clip(np.arange(z_base - h, z_base + Zl + h), 0, a.shape[-3] - 1)
    return np.ascontiguousarray(a[..., rows, :, :])


# ---------------------------------------------------------------------------
# kernel A's slab form (its plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z_base", [0, 8, 24])
def test_slab_plain_matches_jax_slab_contract(z_base):
    """gd_iteration_slab_plain against fused_gd_iteration_db_padded(...,
    z_base=, z_global=) in interpret mode on an 8-row slab of a 32-deep
    volume (first, inner and last slab), momentum 0.9, K=2, 7 taps: psi',
    tnp', vel' within atol 1e-5, the max norm within rtol 1e-5."""
    dims, Zl = (32, 16, 16), 8
    d = _random_slab_inputs(dims)

    def ypad(a):  # the JAX tiles are edge-padded in y as well
        return jnp.asarray(np.pad(a, [(0, 0)] * (a.ndim - 2) + [(H, H), (0, 0)], mode="edge"))

    want = fused_gd_iteration_db_padded(
        ypad(_slab(d["psi"], z_base, Zl)), ypad(_slab(d["tnp"], z_base, Zl)),
        jnp.asarray(d["vel"][:, z_base:z_base + Zl]), ypad(_slab(d["tg"], z_base, Zl)),
        ypad(_slab(d["live"], z_base, Zl)), jnp.float32(0.05), jnp.float32(0.2), TAPS_STATIC,
        K=2, momentum=0.9, interpret=True, z_base=z_base, z_global=dims[0])

    def t(name):
        return torch.from_numpy(_slab(d[name], z_base, Zl))[None]

    got = kernels.gd_iteration_slab(t("psi"), t("tnp"), t("vel"), t("tg"), t("live"),
                                    torch.as_tensor(TAPS), 0.05, 0.2, 0.9, 2, z_base, dims[0],
                                    z_base - H)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(got[3][0]), float(want[3]), rtol=1e-5)


@pytest.mark.parametrize("K,momentum,n_taps", [(2, None, 7), (2, 0.9, 7), (1, 0.95, 3),
                                               (None, 0.9, 5)])
def test_slab_plain_equals_whole_volume_step(K, momentum, n_taps):
    """Each slab of 2 and of 4 equals gd_iteration_plain on the whole
    (16, 8, 12) volume bit for bit: psi', tnp', vel', the max norm over the
    slabs; K None gathers from the whole live volume."""
    dims = (16, 8, 12)
    d = _random_slab_inputs(dims, seed=1)
    taps = torch.as_tensor(js.sobolev_filter_1d(n_taps, 0.1))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    whole = kernels.gd_iteration_plain(t["psi"], t["tnp"], t["vel"], t["tg"], t["live"], taps,
                                       0.05, 0.2, momentum, K, with_energy=True)
    for n_z in (2, 4):
        Zl = dims[0] // n_z
        mx = []
        for j in range(n_z):
            zb = j * Zl
            live, lz0 = ((d["live"], 0) if K is None else (_slab(d["live"], zb, Zl), zb - H))
            got = kernels.gd_iteration_slab(
                *(torch.from_numpy(_slab(d[k], zb, Zl))[None] for k in ("psi", "tnp", "vel", "tg")),
                torch.from_numpy(np.ascontiguousarray(live))[None], taps, 0.05, 0.2, momentum, K,
                zb, dims[0], lz0)
            rows = slice(zb, zb + Zl)
            assert torch.equal(got[0][0], whole[0][:, rows])
            assert torch.equal(got[1][0], whole[1][rows])
            if momentum is not None:
                assert torch.equal(got[2][0], whole[2][:, rows])
            mx.append(float(got[3][0]))
        assert max(mx) == float(whole[3])


def test_slab_plain_freezes_an_inactive_scene_and_checks_its_operands():
    dims, Zl = (16, 8, 12), 8
    d = _random_slab_inputs(dims, seed=2)
    b = {k: torch.from_numpy(np.stack([_slab(v, 8, Zl)] * 2)) for k, v in d.items()}
    got = kernels.gd_iteration_slab(b["psi"], b["tnp"], b["vel"], b["tg"], b["live"],
                                    torch.as_tensor(TAPS), 0.05, 0.2, 0.9, 2, 8, 16, 8 - H,
                                    active=torch.tensor([True, False]), with_energy=True)
    assert torch.equal(got[0][1], b["psi"][1][:, H:H + Zl]) and float(got[3][1]) == 0.0
    assert float(got[4][1]) == 0.0 and float(got[4][0]) > 0.0
    assert not torch.equal(got[0][0], b["psi"][0][:, H:H + Zl])
    with pytest.raises(ValueError, match="at most 7 taps"):
        kernels._check_slab(b["psi"], b["tnp"], b["vel"], b["tg"], b["live"],
                            torch.ones(9), 0.9, 2, 8, 16, 8 - H)
    with pytest.raises(ValueError, match="miss the rows"):
        kernels._check_slab(b["psi"], b["tnp"], b["vel"], b["tg"], b["live"],
                            torch.as_tensor(TAPS), 0.9, None, 8, 16, 8 - H)


# ---------------------------------------------------------------------------
# the halo exchange, its stencils, the window sampler of a slab
# ---------------------------------------------------------------------------


def _shard_map(fn, n_z, in_specs, out_specs):
    from jax import shard_map

    return jax.jit(shard_map(fn, mesh=j_make_mesh(n_z=n_z), in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


@pytest.mark.parametrize("n_z", [1, 4])
def test_halo_exchange_and_stencils_match_jax(n_z):
    """_halo_exchange_z (h = 4 and 2), _zmask, _central_diff_z_halo,
    _second_diff_z_halo and _conv_z_halo of each slab against JAX's inside a
    shard_map over n_z devices: bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 32, 6, 5)).astype(np.float32)
    taps = jnp.asarray(TAPS)

    def local(xl):
        idx, nz = jax.lax.axis_index("z"), jax.lax.axis_size("z")
        xp = jsh._halo_exchange_z(xl, H, "z")
        zm = jsh._zmask(xl.shape[-3], idx == 0, idx == nz - 1)
        return (xp, jsh._halo_exchange_z(xl, 2, "z"), jsh._central_diff_z_halo(xp, H, zm),
                jsh._second_diff_z_halo(xp, H, zm), jsh._conv_z_halo(xp, taps, H))

    spec = P(None, "z")
    want = [np.asarray(a) for a in _shard_map(local, n_z, (spec,), (spec,) * 5)(jnp.asarray(x))]
    mesh = make_mesh(n_z=n_z, devices=["cpu"] * n_z)
    xs = zshard._split(torch.from_numpy(x), mesh.devices[0])
    got = [zshard._halo_exchange_z(xs, H, mesh), zshard._halo_exchange_z(xs, 2, mesh)]
    zm = [zshard._zmask(32 // n_z, j == 0, j == n_z - 1) for j in range(n_z)]
    t = torch.as_tensor(TAPS)
    got += [[zshard._central_diff_z_halo(p, H, m) for p, m in zip(got[0], zm)],
            [zshard._second_diff_z_halo(p, H, m) for p, m in zip(got[0], zm)],
            [zshard._conv_z_halo(p, t, H) for p in got[0]]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(torch.cat(g, dim=-3).numpy(), w)
    rows = 4 * 6 * 5 * 3 * 4  # bytes of an h = 4 halo of one neighbour
    assert mesh.halo_bytes == 2 * (n_z - 1) * (rows + rows // 2)


@pytest.mark.parametrize("K", [1, 2])
def test_sample_window_local_matches_jax(K):
    """_sample_window_local (trilinear and floor) of each slab of 4 from its
    K-halo-extended volume against JAX's: atol 1e-6 (floor exact)."""
    rng = np.random.default_rng(K)
    dims = (32, 6, 5)
    vol = rng.standard_normal(dims).astype(np.float32)
    psi = (np.asarray(jf.identity_field(dims)) + rng.uniform(-2.5, 2.5, (3,) + dims)
           ).astype(np.float32)

    def local(v, p):
        z0 = jax.lax.axis_index("z") * v.shape[-3]
        ve = jsh._halo_exchange_z(v, K, "z")
        return (jsh._sample_window_local(ve, p, z0, K),
                jsh._sample_window_local(ve, p, z0, K, floor=True))

    want = _shard_map(local, 4, (P("z"), P(None, "z")), (P("z"), P("z")))(
        jnp.asarray(vol), jnp.asarray(psi))
    devs = ["cpu"] * 4
    vs = zshard._halo_exchange_z(zshard._split(torch.from_numpy(vol), devs), K)
    ps = zshard._split(torch.from_numpy(psi), devs)
    for k, floor in enumerate((False, True)):
        got = torch.cat([zshard._sample_window_local(v, p, 8 * j, K, floor)
                         for j, (v, p) in enumerate(zip(vs, ps))], dim=-3).numpy()
        np.testing.assert_allclose(got, np.asarray(want[k]), atol=0 if floor else 1e-6, rtol=0)


@pytest.mark.parametrize("aligned", [True, False])
def test_integrate_slab_matches_jax(aligned):
    """integrate_dists of a z-slab (z_offset) against JAX's, rotated and
    axis-aligned poses: the weights exact, the tsdf within 1e-6."""
    dims = (8, 16, 16)
    vs = 0.25 / 16
    rng = np.random.default_rng(4)
    dists = rng.uniform(0.25, 0.45, (24, 32)).astype(np.float32)
    m = np.eye(4, dtype=np.float32)
    if not aligned:
        a = 0.2
        m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    m[:3, 3] = (-0.125, -0.125, 0.2)
    intr = np.asarray([20.0, 20.0, 16.0, 12.0], np.float32)
    zero = jnp.zeros(dims, jnp.float32)
    want = j_integrate(zero, zero, jnp.asarray(dists), jnp.asarray(m), jnp.asarray(intr),
                       jnp.full(3, vs, jnp.float32), jnp.float32(10 * vs), jnp.float32(2 * vs),
                       dims, 16, axis_aligned=aligned)
    tz = torch.zeros(dims)
    got = tsdf.integrate_dists(tz, tz, torch.from_numpy(dists), m, tuple(intr), (vs,) * 3,
                               10 * vs, 2 * vs, axis_aligned=aligned, z_offset=16)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    assert float(got[1].sum()) > 0


# ---------------------------------------------------------------------------
# the sharded solve
# ---------------------------------------------------------------------------

WINDOWED = dict(inverse_iters=12, warp_window=2, fused=True, taps_static=TAPS_STATIC,
                momentum=0.9, warm_inverse=True)
SOLVES = {
    # name: (options, scene shift in voxels, MAX_ITER)
    "exact": (dict(inverse_iters=8), 2.0, 24),
    "windowed": (WINDOWED, 1.5, 24),
    "pyramid": (dict(inverse_iters=2, warp_window=3, momentum=0.9, pyramid_levels=2,
                     coarse_max_iter=12), 2.0, 24),
    "fine_window": (dict(inverse_iters=8, warp_window=2, fine_window=1, momentum=0.9), 1.5, 10),
    "stall": (dict(inverse_iters=2, warp_window=2, momentum=0.9, stall_window=4,
                   stall_rel=0.5), 1.0, 64),
}


def _solve_args(name):
    opts, shift, max_iter = SOLVES[name]
    tg, wg, tn, wn = _scene(shift * SIZE / DIM)
    psi = np.asarray(jf.identity_field((DIM,) * 3))
    extra = (np.asarray(jf.identity_field((DIM,) * 3)) + 0.1,) if opts.get("warm_inverse") else ()
    return (psi, tg, wg, tn, wn), (np.float32(0.1), np.float32(0.4), np.int32(max_iter),
                                   np.float32(-1.0)), extra


@functools.lru_cache(maxsize=None)
def _jax_solve(name):
    """JAX's sharded solve on 4 of the 8 virtual devices, XLA path."""
    opts = dict(SOLVES[name][0], fused=False, taps_static=None)
    arrays, scalars, extra = _solve_args(name)
    fn = jsh.make_sharded_estimate_psi(j_make_mesh(n_z=4), **opts)
    out = fn(*map(jnp.asarray, arrays), jnp.asarray(TAPS), *map(jnp.asarray, scalars),
             *map(jnp.asarray, extra))
    return [np.asarray(a) for a in out]


def _port_solve(name, fused=None, n_z=4):
    opts = dict(SOLVES[name][0])
    if fused is not None:
        opts.update(fused=fused, taps_static=TAPS_STATIC if fused else None)
    arrays, scalars, extra = _solve_args(name)
    mesh = make_mesh(n_z=n_z, devices=["cpu"] * n_z)
    fn = make_sharded_estimate_psi(mesh, **opts)
    out = fn(*map(torch.tensor, arrays), TAPS, *scalars, *map(torch.tensor, extra))
    return [_np(a) for a in out], mesh


@pytest.mark.parametrize("name,fused", [("exact", False), ("windowed", True),
                                        ("windowed", False), ("pyramid", False),
                                        ("pyramid", True), ("fine_window", False),
                                        ("fine_window", True), ("stall", False), ("stall", True)])
def test_sharded_solve_matches_jax(name, fused):
    """make_sharded_estimate_psi on 4 z-slabs against JAX's with the same
    options: equal iterations; psi and tnp within 2e-5, psi_inv and the
    trilinear tail within 1e-4, the floor-warped weights exact, the max norm
    within rtol 1e-4. fused: the fine loop on kernel A's slab form (the
    pyramid's coarse levels always are) or on _gd_step_local."""
    got, _ = _port_solve(name, fused)
    want = _jax_solve(name)
    assert int(got[6]) == int(want[6])
    if name == "stall":
        assert int(got[6]) < SOLVES[name][2]  # the stall stop fired
    for k, atol in ((0, 2e-5), (2, 2e-5), (1, 1e-4), (4, 1e-4), (3, 0), (5, 0)):
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0)
    np.testing.assert_allclose(float(got[7]), float(want[7]), rtol=1e-4)


def test_sharded_pyramid_seam_cost_within_jax_bounds():
    """The per-slab upsample (_upsample2_disp_local) leaves seams at the
    slab boundaries, so the sharded pyramid is not the single-device one.
    Held to tests/test_sharding.py's bounds against the port's single-device
    estimate_psi_pyramid with the same coarse cap (12, coarse_max_iter) and
    threshold schedule: the sharded fine level converges (2e-3) within
    max(4, 15%) of the single-device iterations, at no more than 1.05x its
    data energy."""
    from sobfu_tpu_torch import solver as ts

    tg, wg, tn, wn = _scene(2.0 * SIZE / DIM)
    psi = np.asarray(jf.identity_field((DIM,) * 3))
    args = (np.float32(0.1), np.float32(0.3), 256, np.float32(2e-3))
    opts = dict(levels=2, coarse_max_iter=12, warp_window=3, momentum=0.9, inverse_iters=2)
    ref = ts.estimate_psi_pyramid(*map(torch.tensor, (psi, tg, wg, tn, wn)), TAPS, *args,
                                  **opts)
    assert ref.coarse_iters == 12 and ref.iters < 256 + 12
    mesh = make_mesh(n_z=4, devices=["cpu"] * 4)
    shd = make_sharded_estimate_psi(mesh, inverse_iters=2, warp_window=3, momentum=0.9,
                                    pyramid_levels=2, coarse_max_iter=12)(
        *map(torch.tensor, (psi, tg, wg, tn, wn)), TAPS, *args)
    it_shd = int(shd[6])
    assert it_shd < 256 + 12, "the sharded fine level never converged"
    assert abs(it_shd - ref.iters) <= max(4, int(0.15 * ref.iters)), (it_shd, ref.iters)
    e_ref = float(ts.data_energy(torch.tensor(tg), ref.tsdf_n_psi))
    e_shd = float(ts.data_energy(torch.tensor(tg), shd[2]))
    assert e_shd <= e_ref * 1.05 + 1e-6, (e_shd, e_ref)


def test_windowed_solve_gathers_no_volume(monkeypatch):
    """The windowed solve gathers no whole volume (per slab memory stays at
    slab + halo); the exact mode gathers five (live, psi, tg, wg, wn), the
    all-gathers of JAX's compiled exact solve. The halo bytes are counted
    and the loop's exchanges (psi and tnp, 4 rows each way over each seam
    between card groups) are those of the iterations enqueued: none on one
    device (one group), one seam with the slabs forced into two groups of 2
    (kernels.card_groups patched), whose solve equals the one group's bit
    for bit."""
    one, mesh = _port_solve("windowed")
    assert mesh.gathers == 0 and mesh.halo_bytes > 0
    seams = len(kernels.card_groups([torch.device("cpu")] * 4)) - 1
    per_it = seams * 2 * (3 + 1) * H * DIM * DIM * 4  # each seam both ways, psi and tnp
    assert mesh.loop_halo_bytes == per_it * mesh.loop_iterations
    assert mesh.loop_iterations >= 24
    monkeypatch.setattr(kernels, "card_groups", lambda devices: [(0, 2), (2, 4)])
    two, mesh = _port_solve("windowed")
    per_it = 1 * 2 * (3 + 1) * H * DIM * DIM * 4
    assert mesh.loop_halo_bytes == per_it * mesh.loop_iterations > 0
    assert all(np.array_equal(a, b) for a, b in zip(one, two))
    monkeypatch.undo()
    _, mesh = _port_solve("exact")
    assert mesh.gathers == 5


def test_slab_loop_stops_where_the_whole_volume_loop_does():
    """GdSlabLoop over 2 slabs of (16, 8, 12), driven by the frame step's
    chunk driver, against GdLoop on the whole volume: a norm stop inside a
    chunk of 16 (at iteration 11) and a stall stop, with momentum; the
    iterations, the last norm and the state bit for bit, one host read a
    chunk."""
    dims = (16, 8, 12)
    d = _random_slab_inputs(dims, seed=5, amp=1.0)
    t = {k: torch.from_numpy(v)[None] for k, v in d.items()}
    taps = torch.as_tensor(TAPS)

    def whole(thresh, stall):
        loop = kernels.GdLoop("gd_iteration_scenes", t["psi"], t["tnp"], t["tg"], t["live"],
                              taps, 0.05, 0.2, 0.9, 2, np.float32(thresh), energy=bool(stall))
        it, mn = sharding._run_chunks(loop, 1, 40, thresh, stall, 0.05)
        return it, mn, loop.state()[0]

    def slabs(thresh, stall):
        ps = zshard._split(t["psi"], ["cpu"] * 2)
        tn = zshard._split(t["tnp"], ["cpu"] * 2)
        tg = zshard._halo_exchange_z(zshard._split(t["tg"], ["cpu"] * 2), H)
        lv = zshard._halo_exchange_z(zshard._split(t["live"], ["cpu"] * 2), H)
        loop = kernels.GdSlabLoop(ps, tn, tg, lv, taps, 0.05, 0.2, 0.9, 2, np.float32(thresh),
                                  dims[0], energy=bool(stall))
        kernels.reset_launch_counts()
        it, mn = sharding._run_chunks(loop, 1, 40, thresh, stall, 0.05)
        psi = torch.cat([s[0] for s in loop.state()], dim=-3)
        return it, mn, psi, kernels.host_reads["gd_iteration_slab"]

    it, mn, _ = whole(-1.0, 0)
    norms = []
    loop = kernels.GdLoop("gd_iteration_scenes", t["psi"], t["tnp"], t["tg"], t["live"], taps,
                          0.05, 0.2, 0.9, 2, -1.0)
    rows = loop.run(16, np.ones(1, bool))[1]
    norms = np.sqrt(rows[:, 0])
    j = max(k for k in range(12) if k == 0 or norms[k] < norms[:k].min())
    for thresh, stall in ((float(norms[j]), 0), (-1.0, 8)):
        w_it, w_mn, w_psi = whole(thresh, stall)
        g_it, g_mn, g_psi, reads = slabs(thresh, stall)
        assert g_it.tolist() == w_it.tolist() and g_mn.tolist() == w_mn.tolist()
        assert torch.equal(g_psi, w_psi)
        if stall:
            assert 16 <= int(g_it[0]) < 40 and int(g_it[0]) % 8 == 0  # the stall fired
            assert reads == int(g_it[0]) // 8
        else:
            assert int(g_it[0]) == j + 1 and reads == 1


# ---------------------------------------------------------------------------
# the frame step over a ('scene', 'z') mesh
# ---------------------------------------------------------------------------

FDIMS = (32, 16, 16)
FVS = 0.25 / 16
FH, FW, FF = 48, 64, 40.0
FINTR = np.asarray([FF, FF, FW / 2 - 0.5, FH / 2 - 0.5], np.float32)
Z_CAM, RADIUS = 0.125 + 0.15, 0.05
# __graft_entry__.py's dry-run configuration (its fold_xmats picks a TPU layout)
DRYRUN = dict(inverse_iters=4, warp_window=2, fused=True, taps_static=TAPS_STATIC,
              momentum=0.95, warm_inverse=True, pyramid_levels=2, stall_window=8,
              stall_rel=1e-2, fold_xmats=True)


def _fscalars(max_iter=16):
    return (FINTR, np.full(3, FVS, np.float32), np.float32(8 * FVS), np.float32(3 * FVS),
            np.float32(64.0), TAPS, np.float32(0.1), np.float32(0.2), np.int32(max_iter),
            np.float32(1e-3))


@functools.lru_cache(maxsize=1)
def _render():
    spec = importlib.util.spec_from_file_location(
        "bench_multiscene_stream", os.path.join(ROOT, "tools", "bench_multiscene_stream.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render_dists


def _vol2cam():
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (-FVS * FDIMS[2] / 2, -FVS * FDIMS[1] / 2, 0.15)
    return m


def _stream(S=4, n_frames=2, seed=0):
    """S spheres, each drifting 0.4-0.6 voxel a frame (from the seed) along
    its own direction in the image plane; the canonical integrated at frame
    0. Returns ((psi, tg, wg, psi_inv), per-frame depth batches)."""
    rng = np.random.default_rng(seed)
    dirs = np.asarray([(1, 0), (-1, 0), (0, 1), (0, -1)][:S], np.float64)
    steps = rng.uniform(0.4, 0.6, S) * FVS
    zero = jnp.zeros(FDIMS, jnp.float32)
    sc = _fscalars()
    d0 = _render()(FH, FW, *FINTR, (0.0, 0.0, Z_CAM), RADIUS)
    tg, wg = j_integrate(zero, zero, jnp.asarray(d0), jnp.asarray(_vol2cam()),
                         jnp.asarray(FINTR), jnp.asarray(sc[1]), jnp.float32(sc[2]),
                         jnp.float32(sc[3]), FDIMS)
    psi = np.asarray(jf.identity_field(FDIMS))
    state = tuple(np.broadcast_to(np.asarray(a)[None], (S,) + a.shape).copy()
                  for a in (psi, tg, wg, psi))
    frames = [np.stack([_render()(FH, FW, *FINTR, (d[0] * k * i, d[1] * k * i, Z_CAM), RADIUS)
                        for d, k in zip(dirs, steps)]) for i in range(1, n_frames + 1)]
    return state, frames


def _run(step, state, frames, to_in, to_np, max_iter=16):
    S = state[0].shape[0]
    v2c = np.broadcast_to(_vol2cam()[None], (S, 4, 4)).copy()
    outs = []
    for dists in frames:
        out = [to_np(a) for a in step(*(to_in(a) for a in state[:3]), to_in(dists), to_in(v2c),
                                      *map(to_in, _fscalars(max_iter)), to_in(state[3]))]
        outs.append(out)
        state = (out[0], out[2], out[3], out[1])
    return outs


@functools.lru_cache(maxsize=1)
def _jax_step():
    """JAX's frame step on a (2 scene x 2 z) mesh, XLA path (compiled at its
    first call, MAX_ITER a traced argument)."""
    return jsh.make_frame_step(j_make_mesh(n_z=2, n_scene=2), FDIMS,
                               **dict(DRYRUN, fused=False, taps_static=None))[0]


@functools.lru_cache(maxsize=None)
def _jax_frames(max_iter):
    return _run(_jax_step(), *_stream(), jnp.asarray, np.asarray, max_iter)


def _port_frames(mesh, max_iter, **over):
    step = make_frame_step(FDIMS, mesh=mesh, **dict(DRYRUN, **over))
    return _run(step, *_stream(), lambda a: torch.as_tensor(np.asarray(a)), _np, max_iter)


def _assert_frames(got, want, atol, inv_atol):
    for g, w in zip(got, want):
        assert g[4].tolist() == w[4].tolist()  # per-scene iterations
        for k in (0, 2, 3):  # psi, tg, wg
            np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0)
        np.testing.assert_allclose(g[1], w[1], atol=inv_atol, rtol=0)  # psi_inv
        np.testing.assert_allclose(g[5], w[5], rtol=1e-4)


@pytest.mark.parametrize("max_iter", [16, 48])
def test_frame_step_over_a_mesh_matches_jax(max_iter):
    """make_frame_step over a (2 scene x 2 z) mesh of the CPU, 4 scenes,
    two carried frames, in the dry-run configuration, against JAX's on 4
    virtual devices: at MAX_ITER 16 every level stops at its cap, at 48 the
    fine level on the stall test. Equal per-scene iterations; psi, tg and
    wg within 2e-5 (measured 1.5e-5: coordinates up to 31, an ulp 1.9e-6,
    momentum 0.95 summing the updates' roundings); the last max norm within
    rtol 1e-4 (measured 4.5e-6); psi_inv within 5e-4 (measured 1.6e-4: four
    warm fixed-point steps a frame, carried, each moving psi's differences
    by the displacement's gradient; the port's unfused path measures 5.3e-5
    on the same frames)."""
    mesh = make_mesh(n_z=2, n_scene=2, devices=["cpu"] * 4)
    got = _port_frames(mesh, max_iter)
    _assert_frames(got, _jax_frames(max_iter), 2e-5, 5e-4)
    assert mesh.gathers == 0
    if max_iter == 48:
        fine = np.concatenate([o[4] for o in got]) - 48
        assert (fine < 48).all() and (fine % 8 == 0).all()


def test_frame_step_on_one_slab_matches_the_one_device_step():
    """With one z-slab (a 2 x 1 mesh) the sharded step against the one-device
    make_frame_step, two carried frames at MAX_ITER 16: equal iterations;
    psi, tg and wg within 1e-5, the figure ROADMAP Queue 3 holds the JAX
    step to (measured 7.6e-6), psi_inv within 5e-5 (measured 1.05e-5). The
    differences are the float shift of _sample_window_local in the live
    warp and the tails against the port's window sampler, which the slab
    form and kernel B avoid (Queue 3)."""
    mesh = make_mesh(n_z=1, n_scene=2, devices=["cpu"] * 2)
    got = _port_frames(mesh, 16)
    step = make_frame_step(FDIMS, device="cpu", **DRYRUN)
    want = _run(step, *_stream(), lambda a: torch.as_tensor(np.asarray(a)), _np, 16)
    _assert_frames(got, want, 1e-5, 5e-5)


def test_make_mesh_and_the_sharded_step_check_their_arguments():
    mesh = make_mesh(devices=["cpu"] * 3)
    assert mesh.shape == {"scene": 1, "z": 3}
    assert all(d == torch.device("cpu") for d in mesh.devices[0])
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh(n_z=4, n_scene=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not split"):
        make_frame_step(FDIMS, mesh=mesh, warp_window=2)
    with pytest.raises(ValueError, match="fewer pyramid levels or z-shards"):
        make_frame_step(FDIMS, mesh=make_mesh(n_z=4, devices=["cpu"] * 4), warp_window=2,
                        pyramid_levels=3)
    with pytest.raises(ValueError, match="taps_static"):
        make_sharded_estimate_psi(mesh, warp_window=2, fused=True)
    if not torch.cuda.is_available():  # the mesh's default devices are the cards
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh()
