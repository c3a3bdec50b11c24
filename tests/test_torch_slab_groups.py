"""kernels.GdSlabLoop over card groups on CPU devices (the plain version of
kernel A's slab form on each group's rows).

The grouping (kernels.card_groups) is a pure function of the slabs'
devices; on ``["cpu"] * 4`` every slab is on one device, so the loop runs
one group, and the tests patch card_groups to force two groups of 2 or one
group a slab (the layout of one launch per slab). Each is held to GdLoop on
the whole volume bit for bit (iterations, norm rows, psi, tnp and vel, one
host read a chunk) through a norm stop inside a chunk of 16 and a stall
stop, with momentum; the energies are per slab, so the grouped loops'
energies are held to the ungrouped one's bit for bit and to GdLoop's
whole-volume sum within rtol 1e-6 (another summation order). The halo
bytes are those of the seams between groups.
"""

import numpy as np
import pytest
import torch

from sobfu_tpu_torch import fields, solver
from sobfu_tpu_torch.ops import kernels
from sobfu_tpu_torch.parallel import sharding, zshard

torch.set_num_threads(1)

H = kernels.SLAB_HALO
DIMS = (16, 8, 12)
S = 2
TAPS = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1))
ARGS = (0.05, 0.2, 0.9, 2)  # alpha, w_reg, momentum, K
SPLITS = {"one group": [(0, 4)], "two groups": [(0, 2), (2, 4)],
          "one group a slab": [(0, 1), (1, 2), (2, 3), (3, 4)]}


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    ident = fields.identity_field(DIMS).numpy()
    arrays = dict(psi=ident + rng.uniform(-1.0, 1.0, (S, 3) + DIMS),
                  tnp=rng.standard_normal((S,) + DIMS), tg=rng.standard_normal((S,) + DIMS),
                  live=rng.standard_normal((S,) + DIMS))
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in arrays.items()}


def _whole(d, thresh, energy=False):
    return kernels.GdLoop("gd_iteration_scenes", d["psi"], d["tnp"], d["tg"], d["live"], TAPS,
                          *ARGS, np.float32(thresh), energy=energy)


def _slabs(d, split, thresh, monkeypatch, energy=False):
    """GdSlabLoop over 4 slabs of d on the CPU, its groups those of split."""
    monkeypatch.setattr(kernels, "card_groups", lambda devices: SPLITS[split])
    devs = ["cpu"] * 4
    loop = kernels.GdSlabLoop(
        zshard._split(d["psi"], devs), zshard._split(d["tnp"], devs),
        zshard._halo_exchange_z(zshard._split(d["tg"], devs), H),
        zshard._halo_exchange_z(zshard._split(d["live"], devs), H), TAPS, *ARGS,
        np.float32(thresh), DIMS[0], energy=energy)
    assert loop.groups == SPLITS[split]
    return loop


def _joined(loop):
    """(psi, tnp, vel) of the slab loop's state, the slabs joined along z."""
    return tuple(torch.cat([s[i] for s in loop.state()], dim=-3) for i in range(3))


def _stop_thresh(d) -> tuple:
    """(thresh, j): a norm of scene 0 under every earlier one, at j < 12 of
    the first 16 iterations, so that scene 0 stops after j + 1 of them."""
    rows = _whole(d, -1.0).run(16, np.ones(S, bool))[1]
    norms = np.sqrt(rows[:, 0])
    j = max(k for k in range(12) if k == 0 or norms[k] < norms[:k].min())
    return float(norms[j]), j


@pytest.mark.parametrize("devices,groups", [
    (["cpu"] * 4, [(0, 4)]),
    (["cuda:0"], [(0, 1)]),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], [(0, 2), (2, 4)]),
    (["cuda:0", "cuda:1", "cuda:0"], [(0, 1), (1, 2), (2, 3)]),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], [(0, 1), (1, 2), (2, 3), (3, 4)]),
    (["cuda:0"] * 3 + ["cuda:1"] * 2 + ["cuda:2"] + ["cuda:0"] * 2,
     [(0, 3), (3, 5), (5, 6), (6, 8)]),
])
def test_card_groups_are_the_runs_of_one_device(devices, groups):
    assert kernels.card_groups([torch.device(d) for d in devices]) == groups


@pytest.mark.parametrize("split", list(SPLITS))
def test_grouped_loop_stops_on_the_norm_where_the_whole_volume_loop_does(split, monkeypatch):
    """A chunk of 16 with a norm stop of scene 0 inside it (the other scene
    stops where its own norm says): the iterations, the norm rows and psi,
    tnp and vel of both scenes (their buffers of two parities) bit for bit
    with GdLoop, one host read, launches counted per group launch."""
    d = _inputs()
    thresh, j = _stop_thresh(d)
    whole = _whole(d, thresh)
    want = whole.run(16, np.ones(S, bool))
    loop = _slabs(d, split, thresh, monkeypatch)
    kernels.reset_launch_counts()
    got = loop.run(16, np.ones(S, bool))
    assert int(got[0][0]) == j + 1 and got[0].tolist() == want[0].tolist()
    assert np.array_equal(got[1], want[1])
    for g, w in zip(_joined(loop), whole.state()):
        assert torch.equal(g, w)
    assert kernels.host_reads["gd_iteration_slab"] == 1
    assert loop.iterations == int(got[0].max())


@pytest.mark.parametrize("split", list(SPLITS))
def test_grouped_loop_stalls_where_the_whole_volume_loop_does(split, monkeypatch):
    """The frame step's chunk loop with a stall check every 8 iterations
    (the energy summed over the slabs): the iterations, the last norm and
    the state bit for bit with GdLoop, one host read a chunk."""
    d = _inputs()
    whole = _whole(d, -1.0, energy=True)
    w_it, w_mn = sharding._run_chunks(whole, S, 40, -1.0, 8, 0.05)
    loop = _slabs(d, split, -1.0, monkeypatch, energy=True)
    kernels.reset_launch_counts()
    g_it, g_mn = sharding._run_chunks(loop, S, 40, -1.0, 8, 0.05)
    assert g_it.tolist() == w_it.tolist() and g_mn.tolist() == w_mn.tolist()
    assert 16 <= int(g_it.max()) < 40 and int(g_it.max()) % 8 == 0  # the stall fired
    assert kernels.host_reads["gd_iteration_slab"] == int(g_it.max()) // 8
    for g, w in zip(_joined(loop), whole.state()):
        assert torch.equal(g, w)


def test_grouped_energies_are_the_ungrouped_sums(monkeypatch):
    """Two chunks of 8 with the energy: each split's energies (per slab,
    summed over the slabs on the host) equal the loop of one group a slab
    bit for bit, and GdLoop's whole-volume sum within rtol 1e-6."""
    d = _inputs(seed=6)
    on = np.ones(S, bool)
    whole = _whole(d, -1.0, energy=True)
    want = [whole.run(8, on, with_energy=True)[2] for _ in range(2)]
    got = {}
    for split in SPLITS:
        loop = _slabs(d, split, -1.0, monkeypatch, energy=True)
        got[split] = [loop.run(8, on, with_energy=True)[2] for _ in range(2)]
    for split, e in got.items():
        assert [x.tobytes() for x in e] == [x.tobytes() for x in got["one group a slab"]], split
        np.testing.assert_allclose(np.stack(e), np.stack(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("split", list(SPLITS))
def test_halo_bytes_are_the_seams_between_groups(split, monkeypatch):
    """Each iteration copies H rows of psi (3 channels) and tnp each way
    over each seam between groups, and nothing inside a group."""
    d = _inputs()
    loop = _slabs(d, split, -1.0, monkeypatch)
    loop.run(16, np.ones(S, bool))
    loop.run(5, np.ones(S, bool))
    seams = len(SPLITS[split]) - 1
    assert loop.iterations == 21
    assert loop.halo_bytes == seams * 2 * (3 + 1) * H * DIMS[1] * DIMS[2] * S * 4 * 21


def test_groups_that_do_not_cover_the_slabs_are_refused(monkeypatch):
    d = _inputs()
    monkeypatch.setattr(kernels, "card_groups", lambda devices: [(0, 2), (3, 4)])
    devs = ["cpu"] * 4
    with pytest.raises(ValueError, match="card groups"):
        kernels.GdSlabLoop(zshard._split(d["psi"], devs), zshard._split(d["tnp"], devs),
                           zshard._halo_exchange_z(zshard._split(d["tg"], devs), H),
                           zshard._halo_exchange_z(zshard._split(d["live"], devs), H), TAPS,
                           *ARGS, -1.0, DIMS[0])
