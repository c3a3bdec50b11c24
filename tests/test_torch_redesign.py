"""The chunked gradient-descent loops and kernel A's tile plan, on the CPU.

Kernel A runs many iterations per host call with its stop test on the card
(``kernels.GdLoop``); on the CPU the same loop runs on
``kernels.gd_iterations_plain``. These tests hold, at 16^3:

  - ``gd_iterations_plain`` (n iterations with the freeze) to n chained
    ``gd_iteration_plain`` calls bit for bit;
  - ``solver.estimate_psi`` and ``parallel.sharding._gd_loop_scenes`` to the
    loop they replaced — one plain iteration and one read of the norm per
    iteration, kept here as the reference — in iterations, norm and fields,
    where the norm stops the solve inside a chunk, where max_iter does, and
    where the stall test does;
  - the tile plan (``kernels.gd_tile_plan``) to the card's shared-memory
    limit on every grid the port runs;
  - a numpy emulation of the kernel's ring of dU planes (the cross-shaped
    halo, the clamped fill, the slot arithmetic, the three tap loops) to
    ``solver.sobolev_smooth`` on an edge tile and an interior tile.
"""

import numpy as np
import pytest
import torch

from sobfu_tpu_torch import fields, solver
from sobfu_tpu_torch.ops import kernels
from sobfu_tpu_torch.parallel import sharding

DIMS = (16, 16, 16)
TAPS = solver.sobolev_filter_1d(7, 0.1)


def _scene(seed, amp=1.5, dims=DIMS):
    rng = np.random.default_rng(seed)
    ident = fields.identity_field(dims).numpy()
    arrays = dict(
        psi=ident + rng.uniform(-amp, amp, (3,) + dims),
        tg=rng.standard_normal(dims) * 0.3,
        live=rng.standard_normal(dims) * 0.3,
    )
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in arrays.items()}


def _stop_at(norms, lo, hi):
    """The last iteration in [lo, hi) whose norm is under every earlier one:
    a threshold of that norm stops the loop right after it."""
    ks = [k for k in range(lo, hi) if norms[k] < norms[:k].min()]
    assert ks, "the norms never fall in that range"
    return ks[-1]


# ---------------------------------------------------------------------------
# gd_iterations_plain against chained gd_iteration_plain
# ---------------------------------------------------------------------------


def _chained(b, momentum, K, thresh, active, n, with_energy):
    """n gd_iteration_plain calls per scene, the host deciding who runs."""
    S = b["psi"].shape[0]
    taps = torch.as_tensor(TAPS)
    state = [(b["psi"][s], b["tnp"][s], b["vel"][s] if momentum is not None else None)
             for s in range(S)]
    done, rows, e = np.zeros(S, np.int32), np.zeros((n, S), np.float32), np.zeros(S, np.float32)
    for s in range(S):
        on = bool(active[s])
        for k in range(n):
            if k and on:
                on = bool(np.sqrt(rows[k - 1, s]) > np.float32(thresh))
            if not on:
                break
            out = kernels.gd_iteration_plain(*state[s], b["tg"][s], b["live"][s], taps, 0.05, 0.2,
                                             momentum, K, with_energy and k == n - 1)
            state[s] = out[:3]
            rows[k, s] = float(out[3])
            done[s] += 1
            if with_energy and k == n - 1:
                e[s] = float(out[4])
    return state, done, rows, e


@pytest.mark.parametrize("case", ["mid_chunk", "cap", "inactive_scene"])
def test_gd_iterations_plain_equals_chained_iterations(case):
    n, K, momentum = 12, 2, None if case == "mid_chunk" else 0.9
    scenes = [_scene(s, amp) for s, amp in ((1, 1.5), (2, 0.5), (3, 1.0))]
    b = {k: torch.stack([sc[k] for sc in scenes]) for k in scenes[0]}
    b["tnp"] = torch.stack([kernels.warp_plain(sc["live"][None], sc["psi"], K, (False,))[0]
                            for sc in scenes])
    b["vel"] = torch.zeros_like(b["psi"])
    active = np.array([True, case != "inactive_scene", True])
    thresh = -1.0
    if case == "mid_chunk":
        _, _, rows, _ = _chained(b, momentum, K, -1.0, active, n, False)
        norms = np.sqrt(rows[:, 1])
        thresh = float(norms[_stop_at(norms, 2, n - 2)])
    want_state, want_done, want_rows, want_e = _chained(b, momentum, K, thresh, active, n, True)
    vel = b["vel"] if momentum is not None else None
    psi, tnp, vel, done, rows, e = kernels.gd_iterations_plain(
        b["psi"], b["tnp"], vel, b["tg"], b["live"], torch.as_tensor(TAPS), 0.05, 0.2, momentum,
        K, thresh, active, n, with_energy=True)
    assert done.tolist() == want_done.tolist()
    if case == "mid_chunk":
        assert 0 < done[1] < n
    if case == "inactive_scene":
        assert done[1] == 0 and torch.equal(psi[1], b["psi"][1])
    if case == "cap":
        assert done.tolist() == [n] * 3
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(e, want_e)
    for s, (p, t, v) in enumerate(want_state):
        assert torch.equal(psi[s], p) and torch.equal(tnp[s], t)
        if momentum is not None:
            assert torch.equal(vel[s], v)


# ---------------------------------------------------------------------------
# the chunked solve loops against the loop with one read per iteration
# ---------------------------------------------------------------------------


def _loop_per_iteration(psi, tg, live, K, max_iter, thresh, momentum, stall_window, stall_rel):
    """The loop the chunks replaced: a plain iteration, then the host reads
    the norm (and the energy at a check iteration)."""
    taps = torch.as_tensor(TAPS)
    thresh = float(np.float32(thresh))
    tnp = kernels.warp_plain(live[None], psi, K, (False,))[0]
    vel = torch.zeros_like(psi) if momentum is not None else None
    it, mnorm, e_ref, stalled = 0, float("inf"), float("inf"), False
    while it < max_iter and mnorm > thresh and not stalled:
        it += 1
        at_check = bool(stall_window) and it % stall_window == 0
        out = kernels.gd_iteration_plain(psi, tnp, vel, tg, live, taps, float(np.float32(0.05)),
                                         float(np.float32(0.2)), momentum, K, at_check)
        psi, tnp, vel = out[:3]
        mnorm = float(torch.sqrt(out[3]))
        if at_check:
            e_now = np.float32(float(out[4]))
            stalled = bool(it >= 2 * stall_window and np.float32(e_ref) - e_now
                           < np.float32(stall_rel) * abs(e_now))
            e_ref = float(e_now)
    return psi, tnp, it, mnorm


# (max_iter, thresh from the reference norms or None, momentum, stall_window, stall_rel)
LOOP_CASES = {
    "norm_stop": (64, "inside_chunk", None, 0, 0.0),
    "cap_stop": (21, None, 0.9, 0, 0.0),
    "stall_stop": (64, None, 0.9, 8, 0.5),
}


def _loop_thresh(case, sc, K):
    if LOOP_CASES[case][1] is None:
        return -1.0
    norms = []
    psi, tnp = sc["psi"], kernels.warp_plain(sc["live"][None], sc["psi"], K, (False,))[0]
    for _ in range(30):
        psi, tnp, _, mx = kernels.gd_iteration_plain(psi, tnp, None, sc["tg"], sc["live"],
                                                     torch.as_tensor(TAPS), 0.05, 0.2, None, K)
        norms.append(float(torch.sqrt(mx)))
    norms = np.asarray(norms, np.float32)
    return float(norms[_stop_at(norms, 17, 30)])  # inside the second chunk of 16


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_chunked_estimate_psi_equals_per_iteration_loop(case):
    max_iter, _, momentum, stall_window, stall_rel = LOOP_CASES[case]
    sc, K = _scene(5), 2
    thresh = _loop_thresh(case, sc, K)
    want = _loop_per_iteration(sc["psi"], sc["tg"], sc["live"], K, max_iter, thresh, momentum,
                               stall_window, stall_rel)
    kernels.reset_launch_counts()
    got = solver.estimate_psi(sc["psi"], sc["tg"], sc["tg"], sc["live"], sc["live"], TAPS, 0.05,
                              0.2, max_iter, thresh, warp_window=K, momentum=momentum,
                              stall_window=stall_window, stall_rel=stall_rel, skip_tails=True)
    assert got.iters == want[2]
    assert got.max_norm == want[3]
    assert torch.equal(got.psi, want[0]) and torch.equal(got.tsdf_n_psi, want[1])
    if case == "norm_stop":
        assert got.iters % kernels.GD_CHUNK and got.iters < max_iter
    if case == "stall_stop":
        assert got.iters == 2 * stall_window and got.max_norm > thresh
    # one read per chunk: a chunk ends at GD_CHUNK iterations, a stall check or max_iter
    chunk = min(kernels.GD_CHUNK, stall_window or kernels.GD_CHUNK)
    assert kernels.host_reads["gd_iteration"] == -(-got.iters // chunk)
    assert kernels.launch_counts["gd_iteration"] == 0  # no kernel launches on the CPU


def test_record_energy_rows_through_the_chunked_loop():
    """record_energy reads the state before every iteration (chunks of one):
    the rows are the pre-update energies and the update norm."""
    sc, K = _scene(5), 2
    res = solver.estimate_psi(sc["psi"], sc["tg"], sc["tg"], sc["live"], sc["live"], TAPS, 0.05,
                              0.2, 5, -1.0, warp_window=K, record_energy=True, energy_cap=5,
                              skip_tails=True)
    psi = sc["psi"]
    tnp = kernels.warp_plain(sc["live"][None], psi, K, (False,))[0]
    for i in range(5):
        row = res.energy[i]
        assert float(row[0]) == float(solver.data_energy(sc["tg"], tnp))
        assert float(row[1]) == float(solver.reg_energy_sobolev(psi))
        psi, tnp, _, mx = kernels.gd_iteration_plain(
            psi, tnp, None, sc["tg"], sc["live"], torch.as_tensor(TAPS),
            float(np.float32(0.05)), float(np.float32(0.2)), None, K)
        assert float(row[2]) == float(torch.sqrt(mx))
    assert res.iters == 5 and torch.equal(res.psi, psi)


def _scene_loop_per_iteration(psi, tg, live, max_iter, thresh, K, momentum, stall_window,
                              stall_rel):
    """_gd_loop_scenes as it was: one batched plain iteration and one read
    of the S norms per iteration."""
    S = psi.shape[0]
    taps = torch.as_tensor(TAPS)
    thresh, rel = np.float32(thresh), np.float32(stall_rel)
    tnp = torch.stack([kernels.warp_plain(live[s][None], psi[s], K, (False,))[0]
                       for s in range(S)])
    vel = torch.zeros_like(psi) if momentum is not None else None
    it = np.zeros(S, np.int32)
    mnorm = np.full(S, np.inf, np.float32)
    e_ref = np.full(S, np.inf, np.float32)
    stalled = np.zeros(S, bool)
    while True:
        active = (it < max_iter) & (mnorm > thresh) & ~stalled
        if not active.any():
            break
        it1 = int(it[active][0]) + 1
        at_check = bool(stall_window) and it1 % stall_window == 0
        out = kernels.gd_iteration_scenes_plain(
            psi, tnp, vel, tg, live, taps, float(np.float32(0.05)), float(np.float32(0.2)),
            momentum, K, torch.as_tensor(active), with_energy=at_check)
        psi, tnp, vel = out[:3]
        mnorm = np.where(active, torch.sqrt(out[3]).numpy(), mnorm)
        it = it + active.astype(np.int32)
        if at_check:
            e_now = out[4].numpy()
            stall = (it1 >= 2 * stall_window) & (e_ref - e_now < rel * np.abs(e_now))
            stalled = stalled | (active & stall)
            e_ref = np.where(active, e_now, e_ref)
    return psi, tnp, it, mnorm


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_chunked_scene_loop_equals_per_iteration_loop(case):
    max_iter, _, momentum, stall_window, stall_rel = LOOP_CASES[case]
    K = 2
    scenes = [_scene(s, amp) for s, amp in ((5, 1.5), (6, 0.4), (7, 1.0))]
    b = {k: torch.stack([sc[k] for sc in scenes]) for k in scenes[0]}
    thresh = _loop_thresh(case, scenes[0], K)
    want = _scene_loop_per_iteration(b["psi"], b["tg"], b["live"], max_iter, thresh, K, momentum,
                                     stall_window, stall_rel)
    kernels.reset_launch_counts()
    got = sharding._gd_loop_scenes(b["psi"], b["tg"], b["live"], TAPS, 0.05, 0.2, max_iter,
                                   thresh, K, momentum=momentum, stall_window=stall_window,
                                   stall_rel=stall_rel)
    assert got[2].tolist() == want[2].tolist()
    np.testing.assert_array_equal(got[3], want[3])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "norm_stop":  # the scenes stop at different iterations, one inside a chunk
        assert len(set(got[2].tolist())) > 1 and got[2][0] % kernels.GD_CHUNK
    chunk = min(kernels.GD_CHUNK, stall_window or kernels.GD_CHUNK)
    assert kernels.host_reads["gd_iteration_scenes"] == -(-int(got[2].max()) // chunk)


# ---------------------------------------------------------------------------
# the tile plan
# ---------------------------------------------------------------------------

# every grid the port runs: the goldens, the parity grid, the pyramid's levels
GRIDS = [(16, 16, 16), (12, 16, 20), (8, 8, 8), (32, 32, 32), (64, 64, 64), (128, 128, 128),
         (256, 256, 256), (512, 512, 512), (16, 16, 128), (8, 8, 64), (6, 8, 10)]


@pytest.mark.parametrize("n_taps", [1, 3, 5, 7, 9, 11])
def test_tile_plan_fits_shared_memory_on_every_grid(n_taps):
    for dims in GRIDS:
        p = kernels.gd_tile_plan(dims, n_taps)
        Z, Y, X = dims
        r = n_taps // 2
        assert p["halo"] == r
        assert p["shared_bytes"] == 4 * 3 * (n_taps + 1) * (p["TY"] + 2 * r) * (32 + 2 * r)
        assert p["shared_bytes"] <= 232448
        assert p["tiles_y"] * p["TY"] >= Y > (p["tiles_y"] - 1) * p["TY"]
        assert p["tiles_x"] * 32 >= X > (p["tiles_x"] - 1) * 32
        assert p["segs"] * p["LZ"] >= Z > (p["segs"] - 1) * p["LZ"]
        assert p["blocks"] == p["tiles_y"] * p["tiles_x"] * p["segs"] >= 1


def test_tile_plan_halo_arithmetic_on_the_parity_grid():
    p = kernels.gd_tile_plan((12, 16, 20), 7)
    assert (p["TY"], p["LZ"], p["halo"]) == (8, 4, 3)
    assert (p["tiles_y"], p["tiles_x"], p["segs"], p["blocks"]) == (2, 1, 3, 6)
    assert p["shared_bytes"] == 51072  # 3 channels x 8 slots x 14 x 38 floats
    # 128^3 on 132 SMs: four blocks an SM, 22 planes of dU for 16 of output
    p = kernels.gd_tile_plan((128, 128, 128), 7, n_sm=132)
    assert (p["LZ"], p["blocks"]) == (16, 512)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.gd_tile_plan((16, 16, 16), 41)


# ---------------------------------------------------------------------------
# the ring of dU planes, emulated in numpy
# ---------------------------------------------------------------------------


def _emulate_block(dU, taps, plan, tile):
    """One block of csrc/gd_iteration.cu's gd_fused_kernel on a dU field
    f32[3,Z,Y,X] in numpy: the ring's slots, the clamped fill of the tile
    and its cross-shaped halo (the corners and, on z-halo planes, the whole
    halo stay NaN), and the three tap loops in the kernel's order. Returns
    {(z0, z1, y0, y1, x0, x1): f32[3, ...]} for the block's voxels."""
    ty, tx, seg = tile
    _, Z, Y, X = dU.shape
    NT = len(taps)
    r, TY, TX, LZ = NT // 2, plan["TY"], 32, plan["LZ"]
    slots, HY, HX = NT + 1, TY + 2 * r, TX + 2 * r
    gy0, gx0, z0 = ty * TY, tx * TX, seg * LZ
    z1 = min(z0 + LZ, Z)
    ring = np.full((3, slots, HY, HX), np.nan, np.float32)
    w = np.asarray(taps, np.float32)
    y1, x1 = min(gy0 + TY, Y), min(gx0 + TX, X)
    out = np.full((3, z1 - z0, y1 - gy0, x1 - gx0), np.nan, np.float32)

    def fill(p):
        slot = (p - (z0 - r)) % slots
        cross = z0 <= p < z1
        zc = min(max(p, 0), Z - 1)
        ring[:, slot] = np.nan
        lys = np.arange(0, HY) if cross else np.arange(r, r + TY)
        lxs = np.arange(r, r + TX)
        ys = np.clip(gy0 + lys - r, 0, Y - 1)
        xs = np.clip(gx0 + lxs - r, 0, X - 1)
        ring[:, slot, lys[:, None], lxs[None, :]] = dU[:, zc][:, ys[:, None], xs[None, :]]
        if cross:
            lys = np.arange(r, r + TY)
            lxs = np.concatenate([np.arange(0, r), np.arange(TX + r, TX + 2 * r)])
            ys = np.clip(gy0 + lys - r, 0, Y - 1)
            xs = np.clip(gx0 + lxs - r, 0, X - 1)
            ring[:, slot, lys[:, None], lxs[None, :]] = dU[:, zc][:, ys[:, None], xs[None, :]]

    for p in range(z0 - r, z1 + r + 1):
        if p < z1 + r:
            fill(p)
        zo = p - r - 1
        if zo < z0:
            continue
        sb = (zo - z0 + 2 * r) % slots
        s0 = (zo - z0 + r) % slots
        ny, nx = y1 - gy0, x1 - gx0
        cx = np.zeros((3, ny, nx), np.float32)
        cy, cz = cx.copy(), cx.copy()
        for u in range(NT):
            su = sb - u
            su = su + slots if su < 0 else su
            cx = cx + w[u] * ring[:, s0, r:r + ny, 2 * r - u:2 * r - u + nx]
            cy = cy + w[u] * ring[:, s0, 2 * r - u:2 * r - u + ny, r:r + nx]
            cz = cz + w[u] * ring[:, su, r:r + ny, r:r + nx]
        out[:, zo - z0] = (cx + cy) + cz
    return (z0, z1, gy0, y1, gx0, x1), out


@pytest.mark.parametrize("dims,n_taps,tile", [
    ((12, 16, 20), 7, (1, 0, 0)),    # an edge tile: y, x and z faces, X under a tile's width
    ((12, 16, 20), 7, (0, 0, 2)),    # the last z segment
    ((12, 24, 96), 7, (1, 1, 1)),    # an interior tile: no face within reach
    ((12, 16, 20), 11, (1, 0, 1)),   # the widest halo
    ((12, 16, 20), 3, (0, 0, 0)),
])
def test_ring_emulation_equals_sobolev_smooth(dims, n_taps, tile):
    rng = np.random.default_rng(13)
    dU = rng.standard_normal((3,) + dims).astype(np.float32)
    taps = solver.sobolev_filter_1d(n_taps, 0.1)
    plan = kernels.gd_tile_plan(dims, n_taps)
    assert tile[0] < plan["tiles_y"] and tile[1] < plan["tiles_x"] and tile[2] < plan["segs"]
    (z0, z1, y0, y1, x0, x1), got = _emulate_block(dU, taps, plan, tile)
    want = solver.sobolev_smooth(torch.as_tensor(dU), torch.as_tensor(taps)).numpy()
    assert np.isfinite(got).all()  # no tap ever read a corner or a z-halo plane's halo
    np.testing.assert_allclose(got, want[:, z0:z1, y0:y1, x0:x1], rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# kernel E's loop (kernels.GdMultiLoop) against the per-chunk loop
# ---------------------------------------------------------------------------


def _chunk_loop(psi, tg, live, K, max_iter, thresh, momentum, stall_window, stall_rel, n=16):
    """The loop GdMultiLoop replaced: one kernel E chunk of n iterations,
    then the host reads its last norm (and its last energy at a check)."""
    taps = torch.as_tensor(TAPS)
    thresh = float(np.float32(thresh))
    tnp = kernels.warp_plain(live[None], psi, K, (False,))[0]
    vel = torch.zeros_like(psi) if momentum is not None else None
    it, mnorm, e_ref, stalled = 0, float("inf"), float("inf"), False
    while it < max_iter and mnorm > thresh and not stalled:
        it += n
        at_check = bool(stall_window) and it % stall_window == 0
        out = kernels.gd_multi_plain(psi, tnp, vel, tg, live, taps, float(np.float32(0.05)),
                                     float(np.float32(0.2)), momentum, K, n, with_energy=at_check)
        psi, tnp, vel = out.psi, out.tnp, out.vel
        mnorm = float(torch.sqrt(out.mx_sq[-1]))
        if at_check:
            stalled, e_ref = solver.stall_check(float(out.e_data[-1]), e_ref, it, stall_window,
                                                stall_rel)
    return psi, tnp, it, mnorm


def _x64(dims, seed):
    """A smooth x-profile and its copy moved 1.2 voxels, on an X = 64 grid
    where the fold rule runs kernel E (solver.runs_gd_multi)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.arange(d, dtype=np.float32) for d in dims], indexing="ij")
    ph = rng.uniform(0, 2 * np.pi, 2)

    def profile(shift):
        p = (x - 32 - shift - 0.5 * np.sin(z + ph[0]) - 0.3 * np.cos(y + ph[1])) / 4
        return torch.as_tensor(np.clip(p, -1, 1).astype(np.float32))

    return fields.identity_field(dims), profile(0.0), profile(1.2)


# (max_iter, the norm stop's chunk or None, momentum, stall_window, stall_rel)
E_LOOP_CASES = {
    "norm_stop_mid_call": (400, 3, 0.95, 0, 0.0),
    "cap_40": (40, None, 0.95, 0, 0.0),
    "cap_over_8_chunks": (200, None, None, 0, 0.0),
    "stall_stop": (400, None, 0.95, 16, 1e-2),
}


@pytest.mark.parametrize("dims", [(8, 8, 64), (16, 16, 64)], ids=["8x8x64", "16x16x64"])
@pytest.mark.parametrize("case", list(E_LOOP_CASES))
def test_e_loop_equals_per_chunk_loop(case, dims):
    """solver.estimate_psi with inner_steps=16 (GdMultiLoop on the plain
    version: up to GD_MULTI_LAUNCHES chunks per host read, the stop rule
    tested per chunk as the card tests it) against one chunk and one read
    per chunk: the same iterations, norm and fields bit for bit, with a norm
    stop inside a chunk in the middle of a call, caps of 40 (overshot to 48)
    and 200 (13 chunks, two reads), and a stall stop."""
    max_iter, stop_chunk, momentum, stall_window, stall_rel = E_LOOP_CASES[case]
    psi, tg, live = _x64(dims, 3)
    K, thresh = 2, -1.0
    if stop_chunk is not None:  # a norm between chunk stop_chunk's first and last ones
        rows = kernels.gd_multi_plain(psi, kernels.warp_plain(live[None], psi, K, (False,))[0],
                                      torch.zeros_like(psi), tg, live, torch.as_tensor(TAPS),
                                      0.05, 0.2, momentum, K, 16 * stop_chunk).mx_sq
        norms = np.sqrt(rows.numpy())[16 * (stop_chunk - 1):]
        thresh = float(np.sort(norms)[8])
    want = _chunk_loop(psi, tg, live, K, max_iter, thresh, momentum, stall_window, stall_rel)
    kernels.reset_launch_counts()
    got = solver.estimate_psi(psi, tg, tg, live, live, TAPS, 0.05, 0.2, max_iter, thresh,
                              warp_window=K, momentum=momentum, stall_window=stall_window,
                              stall_rel=stall_rel, skip_tails=True, inner_steps=16)
    assert got.iters == want[2] and got.max_norm == want[3]
    assert torch.equal(got.psi, want[0]) and torch.equal(got.tsdf_n_psi, want[1])
    chunks = got.iters // 16
    if stop_chunk is not None:
        assert chunks == stop_chunk and got.max_norm <= thresh
    if case.startswith("cap"):
        assert got.iters == -(-max_iter // 16) * 16
    if case == "stall_stop":
        assert got.iters < max_iter and got.max_norm > thresh
    assert kernels.host_reads["gd_multi"] == -(-chunks // kernels.GD_MULTI_LAUNCHES)


def test_e_loop_refuses_a_stopped_loop_and_oversized_calls():
    psi, tg, live = _x64((8, 8, 64), 4)
    tnp = kernels.warp_plain(live[None], psi, 2, (False,))[0]
    loop = kernels.GdMultiLoop(psi, tnp, tg, live, torch.as_tensor(TAPS), 0.05, 0.2, None, 2,
                               -1.0, 16, 16)
    with pytest.raises(ValueError, match="launches"):
        loop.run(kernels.GD_MULTI_LAUNCHES + 1)
    assert loop.run(2)[0] == 1 and loop.count == 16 and not loop.running
    with pytest.raises(ValueError, match="stopped"):
        loop.run(1)


# e_now, e_ref, it1 with stall_window 16, stall_rel 0.25: the threshold
# 0.25 * |e_now| and e_ref - e_now at and around it, non-finite energies
STALL_EDGES = [
    (100.0, 125.0, 32),                                 # e_ref - e_now == the threshold
    (100.0, float(np.nextafter(np.float32(125), 0)), 32),  # one ulp under it: stalls
    (100.0, float(np.nextafter(np.float32(125), 200)), 32),
    (100.0, 110.0, 16),                                 # it1 < 2 stall_window
    (-100.0, -80.0, 48),                                # a negative energy
    (3e38, float("inf"), 32),                           # inf - e_now
    (float("inf"), float("inf"), 32),                   # inf - inf is NaN
    (float("nan"), 1.0, 32),
    (1.0, float("nan"), 32),
    (1e-40, 1e-40, 32),                                 # subnormals
    (0.0, 0.0, 32),
]


def _card_stall(e_now, e_ref, it1, stall_window, stall_rel):
    """csrc/gd_multi.cu's stall decision, step by step in numpy float32:
    it1 >= 2 stall_window && __fsub_rn(e_ref, e_now) < __fmul_rn(stall_rel,
    fabsf(e_now)), each operation one rounding."""
    e_now, e_ref, rel = np.float32(e_now), np.float32(e_ref), np.float32(stall_rel)
    with np.errstate(invalid="ignore", over="ignore"):
        d = np.subtract(e_ref, e_now, dtype=np.float32)
        t = np.multiply(rel, np.abs(e_now), dtype=np.float32)
    return bool(it1 >= 2 * stall_window and d < t)


@pytest.mark.parametrize("e_now,e_ref,it1", STALL_EDGES)
def test_card_stall_predicate_equals_stall_check(e_now, e_ref, it1):
    """A numpy emulation of the decision kernel E makes on the card equals
    the host's solver.stall_check (which GdMultiLoop's CPU path and kernel
    A's loop use) on edge values."""
    with np.errstate(invalid="ignore", over="ignore"):
        want = solver.stall_check(e_now, e_ref, it1, 16, 0.25)[0]
    assert _card_stall(e_now, e_ref, it1, 16, 0.25) is want
    if (e_now, e_ref) == (100.0, 125.0):
        assert want is False
    if e_ref == float(np.nextafter(np.float32(125), 0)):
        assert want is True


# ---------------------------------------------------------------------------
# kernel C's thread-to-voxel mapping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(12, 16, 20), (6, 8, 10), (64, 64, 64)])
def test_inverse_mapping_covers_every_voxel_once(dims):
    """csrc/inverse.cu: block b's thread t takes voxels b * 256 * kPer + t +
    j * 256 (j < kPer), each decoded by one 32-bit division chain; over the
    launch's grid every voxel is written exactly once, at its own (x, y, z)."""
    Z, Y, X = dims
    N = Z * Y * X
    per, tile = kernels.INVERSE_PER, kernels.TILE
    blocks = -(-(-(-N // per)) // tile)
    b, t, j = np.meshgrid(np.arange(blocks), np.arange(tile), np.arange(per), indexing="ij")
    i = (b * tile * per + t + j * tile).ravel()
    i = i[i < N]
    assert np.array_equal(np.bincount(i, minlength=N), np.ones(N, np.int64))
    row = i // X
    x, z = i - row * X, row // Y
    y = row - z * Y
    assert np.array_equal(np.stack([z, y, x]), np.stack(np.unravel_index(i, dims)))
