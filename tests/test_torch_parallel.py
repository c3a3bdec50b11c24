"""The scene-batched frame step, sobfu_tpu_torch.parallel.make_frame_step,
against sobfu_tpu.parallel.make_frame_step on a one-device JAX CPU mesh.

On a (1 scene x 1 z) mesh the JAX step runs the scenes under jax.vmap and
its fused fine loop through fused_gd_iteration_db_padded (the pallas_call
at pallas_kernels.py:1208) in interpret mode; the port runs its plain torch
path. S = 2 spheres drifting in different directions, rendered by the ray
caster of tools/bench_multiscene_stream.py at per-frame steps drawn from a
numpy seed, on a 16^3 grid; 2 frames with psi, tg, wg and psi_inv carried.
Each JAX configuration compiles once per module, and runs at two caps:
MAX_ITER 16 (every level stops at its cap) and 48 (the coarse level at its
cap, the fine level on the stall test, at 16 or 24 iterations).

Tolerances: equal per-scene iteration counts; psi, psi_inv, tg and wg
within atol 1e-5 (measured at most 7.7e-6); the last max norm within rtol
1e-5 where the fine level stops on the stall (measured at most 5.7e-6) and
3e-5 where it stops at the cap of 16 (measured 1.41e-5; ROADMAP Queue 3).
psi holds absolute voxel coordinates, so every rounding difference (sums
in another order, XLA's contracted multiply-adds, the JAX step's window
sampling of a K-halo-extended volume at shifted coordinates: ROADMAP Queue
3) is an ulp of a coordinate (1e-6 at 8-16), which the Laplacian of the
coordinates carries into every update, and momentum 0.95 sums updates over
the loop; test_norm_moves_by_an_ulp_of_psi measures what one ulp of the
carried psi alone does to the port's own norm. The port-only tests run on a
non-cubic grid.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import fields as jf
from sobfu_tpu import solver as js
from sobfu_tpu.parallel import make_mesh
from sobfu_tpu.parallel import sharding as jsh
from sobfu_tpu.tsdf import integrate_dists as j_integrate
from sobfu_tpu_torch.ops import kernels
from sobfu_tpu_torch.parallel import make_frame_step, sharding

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (16, 16, 16)  # the JAX comparisons; the port-only tests take a non-cubic grid
NON_CUBIC = (16, 16, 24)
SIZE = 0.25
VS = SIZE / 16
H, W, F = 48, 64, 40.0
INTR = np.asarray([F, F, W / 2 - 0.5, H / 2 - 0.5], np.float32)
Z_CAM, RADIUS = SIZE / 2 + 0.15, 0.05
TAPS = js.sobolev_filter_1d(7, 0.1)
# tools/bench_multiscene_stream.py:79-84 (fold_xmats picks a TPU layout; the
# port ignores it), with MAX_ITER cut to 16 or 48 (CAPS)
WINDOWED = dict(inverse_iters=3, warp_window=2, fused=True,
                taps_static=tuple(float(t) for t in TAPS), momentum=0.95, warm_inverse=True,
                pyramid_levels=2, stall_window=8, stall_rel=1e-2, fold_xmats=True)
CONFIGS = {
    "windowed": WINDOWED,
    "exact": dict(inverse_iters=3, momentum=0.95, warm_inverse=True, stall_window=8,
                  stall_rel=1e-2),
    "fine_window": dict(WINDOWED, fine_window=1),
}
# MAX_ITER -> the max norm's rtol: at 16 every level stops at its cap, at 48
# the fine level stops on the stall test
CAPS = {16: 3e-5, 48: 1e-5}


def _scalars(max_iter=16):
    return (INTR, np.full(3, VS, np.float32), np.float32(8 * VS), np.float32(3 * VS),
            np.float32(64.0), TAPS, np.float32(0.1), np.float32(0.2), np.int32(max_iter),
            np.float32(1e-3))


@functools.lru_cache(maxsize=1)
def _stream_tool():
    spec = importlib.util.spec_from_file_location(
        "bench_multiscene_stream", os.path.join(ROOT, "tools", "bench_multiscene_stream.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _render(centre):
    return _stream_tool().render_dists(H, W, INTR[0], INTR[1], INTR[2], INTR[3], centre,
                                       RADIUS)


def _vol2cam(dims=DIMS):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (-VS * dims[2] / 2, -VS * dims[1] / 2, 0.15)
    return m


def _stream(dirs, seed=0, n_frames=2, dims=DIMS):
    """(the canonical state, per-frame depth batches): every scene starts
    from the sphere integrated at frame 0 and drifts along its own
    direction by a step drawn from the seed (0.4-0.6 voxel a frame)."""
    rng = np.random.default_rng(seed)
    steps = rng.uniform(0.4, 0.6, len(dirs)) * VS
    S = len(dirs)
    zero = jnp.zeros(dims, jnp.float32)
    sc = _scalars()
    tg, wg = j_integrate(zero, zero, jnp.asarray(_render((0.0, 0.0, Z_CAM))),
                         jnp.asarray(_vol2cam(dims)), jnp.asarray(INTR), jnp.asarray(sc[1]),
                         jnp.float32(sc[2]), jnp.float32(sc[3]), dims)
    psi = np.asarray(jf.identity_field(dims))
    state = tuple(np.broadcast_to(np.asarray(a)[None], (S,) + a.shape).copy()
                  for a in (psi, tg, wg, psi))  # psi, tg, wg, psi_inv
    frames = [np.stack([_render((d[0] * k * i, d[1] * k * i, Z_CAM))
                        for d, k in zip(np.asarray(dirs, np.float64), steps)])
              for i in range(1, n_frames + 1)]
    return state, frames


def _run(step, state, frames, to_input, to_numpy, max_iter=16):
    """Carry (psi, tg, wg, psi_inv) through the frames; per frame the six
    outputs as numpy."""
    S = state[0].shape[0]
    v2c = np.broadcast_to(_vol2cam(state[1].shape[1:])[None], (S, 4, 4)).copy()
    outs = []
    for dists in frames:
        psi, tg, wg, inv = (to_input(a) for a in state)
        out = [to_numpy(a) for a in step(psi, tg, wg, to_input(dists), to_input(v2c),
                                         *map(to_input, _scalars(max_iter)), inv)]
        outs.append(out)
        state = (out[0], out[2], out[3], out[1])
    return outs


def _jax(cfg):
    mesh = make_mesh(n_z=1, n_scene=1, devices=jax.devices()[:1])
    step, _ = jsh.make_frame_step(mesh, DIMS, **cfg)
    return lambda state, frames, max_iter=16: _run(step, state, frames, jnp.asarray,
                                                   np.asarray, max_iter)


def _port(cfg, state, frames, max_iter=16):
    step = make_frame_step(state[1].shape[1:], device="cpu", **cfg)
    return _run(step, state, frames, lambda a: torch.as_tensor(np.asarray(a)),
                lambda a: a.numpy(), max_iter)


@pytest.fixture(scope="module")
def jax_steps():
    """Each configuration's JAX step, compiled at its first call."""
    return {name: _jax(cfg) for name, cfg in CONFIGS.items()}


def _pyramid(cfg):
    return cfg.get("pyramid_levels", 1) > 1


@pytest.fixture(scope="module")
def drift():
    return _stream([[1, 0, 0], [0, -1, 0]])


def _assert_frames(got, want, mnorm_rtol=CAPS[16]):
    for g, w in zip(got, want):
        assert g[4].tolist() == w[4].tolist()  # per-scene iterations
        for k in range(4):  # psi, psi_inv, tg, wg
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g[5], w[5], rtol=mnorm_rtol)


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_frame_step_matches_jax(name, cap, jax_steps, drift):
    """At MAX_ITER 16 both levels run to the cap; at 48 the coarse level
    does and the fine level stops on the stall test (the per-scene check
    iteration, A's fixed-order energy against JAX's sum, e_ref) before it."""
    state, frames = drift
    got = _port(CONFIGS[name], state, frames, cap)
    _assert_frames(got, jax_steps[name](state, frames, cap), CAPS[cap])
    coarse = cap if _pyramid(CONFIGS[name]) else 0
    for o in got:
        fine = o[4] - coarse
        if cap == 16:
            assert fine.tolist() == [cap] * 2
        else:
            # stopped on the stall: at a check iteration, from the second on
            assert (fine >= 16).all() and (fine < cap).all() and (fine % 8 == 0).all()


def test_norm_moves_by_an_ulp_of_psi(drift):
    """What one ulp of the carried psi does to the port's own max norm: the
    windowed step run on psi and on psi moved by one ulp (up or down, a coin
    per component) at MAX_ITER 16. The relative change of the last norm is
    at least 1e-6 (measured 3.8e-6) and the fields stay within 1e-5: an ulp
    of an absolute coordinate alone moves the norm by the order of its
    distance from JAX's (1.41e-5), where the two steps round differently at
    every iteration."""
    state, frames = drift
    psi = state[0]
    coin = np.random.default_rng(0).random(psi.shape) < 0.5
    moved = np.where(coin, np.nextafter(psi, np.float32(np.inf)),
                     np.nextafter(psi, np.float32(-np.inf))).astype(np.float32)
    base = _port(WINDOWED, state, frames)
    nudged = _port(WINDOWED, (moved,) + state[1:], frames)
    rel = max(float(np.max(np.abs(n[5] - b[5]) / b[5])) for n, b in zip(nudged, base))
    assert 1e-6 <= rel < CAPS[16]
    for n, b in zip(nudged, base):
        assert n[4].tolist() == b[4].tolist()
        for k in range(4):
            np.testing.assert_allclose(n[k], b[k], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batched_scenes_equal_solo_runs(name):
    """Scene s of the S = 2 batch equals an S = 1 run of scene s bit for bit."""
    state, frames = _stream([[1, 0, 0], [0, -1, 0]], dims=NON_CUBIC)
    batch = _port(CONFIGS[name], state, frames)
    for s in range(2):
        solo = _port(CONFIGS[name], tuple(a[s:s + 1] for a in state),
                     [f[s:s + 1] for f in frames])
        for b, o in zip(batch, solo):
            for k in range(6):
                np.testing.assert_array_equal(b[k][s], o[k][0])


def test_stopped_scene_stays_frozen(jax_steps):
    """A scene with no motion stops at its first iteration on each level (its
    update is 0) while the drifting one runs to the cap; its iterations
    equal JAX's and its psi and psi_inv stay the identity."""
    state, frames = _stream([[0, 0, 0], [1, 0, 0]], seed=1)
    got = _port(WINDOWED, state, frames)
    _assert_frames(got, jax_steps["windowed"](state, frames))
    ident = state[0][0]
    for o in got:
        assert o[4].tolist() == [2, 32]
        np.testing.assert_array_equal(o[0][0], ident)
        np.testing.assert_array_equal(o[1][0], ident)


def test_gd_loop_freezes_a_scene_at_its_stop():
    """In the batched loop a scene that stops early (here on the stall test)
    keeps its state while the other iterates on: each scene equals its solo
    run bit for bit, iterations and last norm included."""
    rng = np.random.default_rng(5)
    dims = (8, 8, 12)
    ident = np.asarray(jf.identity_field(dims))
    amp = np.asarray([0.05, 1.0], np.float32)[:, None, None, None, None]
    psi = (ident + amp * rng.uniform(-1, 1, (2, 3) + dims)).astype(np.float32)
    tg = rng.standard_normal((2,) + dims).astype(np.float32)
    tg[0] = 0.0  # scene 0 only smooths its noise; scene 1 chases a random target
    live = tg + np.asarray([0.0, 0.3], np.float32)[:, None, None, None] * rng.standard_normal(
        (2,) + dims).astype(np.float32)
    t = [torch.from_numpy(a) for a in (psi, tg, live)]
    args = (TAPS, 0.1, 0.2, 40, 1e-3, 2)
    kw = dict(momentum=0.9, stall_window=8, stall_rel=1e-3)
    b_psi, b_tnp, b_it, b_mn = sharding._gd_loop_scenes(*t, *args, **kw)
    assert b_it.tolist() == [40, 16]  # scene 1 stalls at the first check that may stop
    for s in range(2):
        o_psi, o_tnp, o_it, o_mn = sharding._gd_loop_scenes(*(a[s:s + 1] for a in t), *args,
                                                            **kw)
        assert torch.equal(b_psi[s], o_psi[0]) and torch.equal(b_tnp[s], o_tnp[0])
        assert b_it[s] == o_it[0] and b_mn[s] == o_mn[0]


def test_pyramid_resamples_match_jax():
    """The 2x mean pool and the doubled trilinear upsample of the sharded
    warm start (sharding.py:286-291, :455-462); atol 1e-6."""
    rng = np.random.default_rng(3)
    vol = rng.standard_normal((3,) + NON_CUBIC).astype(np.float32)
    np.testing.assert_allclose(
        sharding._downsample2_local(torch.from_numpy(vol)).numpy(),
        np.asarray(jsh._downsample2_local(jnp.asarray(vol))), atol=1e-6)
    half = vol[:, ::2, ::2, ::2].copy()
    np.testing.assert_allclose(
        sharding._upsample2_disp_local(torch.from_numpy(half), NON_CUBIC).numpy(),
        np.asarray(jsh._upsample2_disp_local(jnp.asarray(half), NON_CUBIC)), atol=1e-6)


@pytest.mark.parametrize("K", [1, 2])
def test_halo_window_sampling_divergence(K):
    """The JAX step's window sampler of the K-halo-extended z-block at
    shifted coordinates (_sample_window_local; on one device the halo is the
    edge replica) against the port's window sampler of the volume as it is:
    the floor rule bit for bit, the trilinear one within 5e-6 on a
    standard-normal volume (measured 2.4e-6; 2.4e-5 at Z = 128, where the
    shifted coordinate z + K rounds at the ulp of 128). ROADMAP Queue 3."""
    rng = np.random.default_rng(K)
    vol = rng.standard_normal(NON_CUBIC).astype(np.float32)
    psi = (np.asarray(jf.identity_field(NON_CUBIC))
           + rng.uniform(-2.5, 2.5, (3,) + NON_CUBIC)).astype(np.float32)
    ext = jnp.pad(jnp.asarray(vol), [(K, K), (0, 0), (0, 0)], mode="edge")
    tv, tp = torch.from_numpy(vol), torch.from_numpy(psi)
    np.testing.assert_array_equal(
        np.asarray(jsh._sample_window_local(ext, jnp.asarray(psi), 0, K, floor=True)),
        kernels.warp(tv[None], tp, K, (True,))[0].numpy())
    np.testing.assert_allclose(
        np.asarray(jsh._sample_window_local(ext, jnp.asarray(psi), 0, K)),
        kernels.warp(tv[None], tp, K, (False,))[0].numpy(), atol=5e-6, rtol=0)


def test_make_frame_step_checks_its_options():
    with pytest.raises(ValueError, match="taps_static"):
        make_frame_step(DIMS, warp_window=2, fused=True, device="cpu")
    with pytest.raises(ValueError, match="requires warp_window"):
        make_frame_step(DIMS, fine_window=1, device="cpu")
    with pytest.raises(ValueError, match="fewer pyramid levels"):
        make_frame_step(DIMS, warp_window=2, pyramid_levels=4, device="cpu")
    step = make_frame_step(DIMS, warm_inverse=True, device="cpu")
    state, frames = _stream([[1, 0, 0]])
    with pytest.raises(TypeError, match="warm_inverse"):
        step(*(torch.from_numpy(a) for a in state[:3]), torch.from_numpy(frames[0]),
             _vol2cam()[None], *_scalars())
    if not torch.cuda.is_available():  # the step runs on the card by default
        with pytest.raises(RuntimeError, match="is_available"):
            make_frame_step(DIMS)
