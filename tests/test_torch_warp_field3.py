"""warp_field3 (kernel B on three channels) and B's launch shapes on the CPU.

The plain version against the JAX package on (12, 16, 20) and 17^3, at
chip_smoke.py's smooth field (sines along z, y and x with random phases)
and at positions beyond the grid: the exact form against XLA's
``sample_field_trilinear`` (atol 2e-5: 3 ulps at the coordinates here), the
K form against ``window_warp_field3_pallas`` in interpret mode (atol 1e-4,
JAX's kernel bound) and its XLA window sampler (2e-5). The plain version
bit for bit with B's plain version channel by channel, the invariant the
card holds the kernel to. csrc/warp.cu's thread-to-voxel mapping
(``kernels.WARP_LAUNCH``: rows or 3-D tiles) covers every voxel of odd and
non-cubic grids exactly once, and the table matches the source's launches.
"""

import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import fields as jf
from sobfu_tpu.ops.pallas_kernels import window_warp_field3_pallas
from sobfu_tpu_torch.ops import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32

# small tensors, and the suite runs one worker per core: one torch thread each
torch.set_num_threads(1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smooth_displacement = _chip_smoke().smooth_displacement


def _ident(dims):
    return np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")[::-1]).astype(F32)


def _operands(dims, kind, amp, seed=3):
    """(field, pos) f32[3, *dims]: the field id + U(-2, 2); pos at the smooth
    field of amp voxels (wavelength 8 on these small grids) or, for
    "outside", id + U(-amp, amp) with a tenth of the voxels 40 voxels off."""
    rng = np.random.default_rng(seed)
    ident = _ident(dims)
    field = ident + rng.uniform(-2.0, 2.0, (3,) + dims).astype(F32)
    if kind == "smooth":
        pos = ident + smooth_displacement(dims, amp, seed, wavelength=8.0)
    else:
        pos = ident + rng.uniform(-amp, amp, (3,) + dims).astype(F32)
        far = rng.random(dims) < 0.1
        pos[:, far] += rng.choice([-40.0, 40.0], (3, int(far.sum()))).astype(F32)
    return field, pos.astype(F32)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("kind,amp", [("smooth", 3.5), ("outside", 6.0)])
@pytest.mark.parametrize("dims", [(12, 16, 20), (17, 17, 17)])
def test_field3_exact_plain_matches_xla(dims, kind, amp):
    """The exact form (K None: the unfused composition, the incremental
    inverse's sample) against sobfu_tpu.fields.sample_field_trilinear."""
    field, pos = _operands(dims, kind, amp)
    got = kernels.warp_field3(torch.from_numpy(field), torch.from_numpy(pos), None)
    want = jf.sample_field_trilinear(jnp.asarray(field), jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("kind,amp", [("smooth", 1.95), ("outside", 3.5)])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_field3_window_plain_matches_pallas(K, kind, amp):
    """The K form against window_warp_field3_pallas in interpret mode and the
    XLA window sampler on (12, 16, 20), inside the window and beyond it
    (both clamp the displacement to [-K, K))."""
    field, pos = _operands((12, 16, 20), kind, amp)
    got = kernels.warp_field3(torch.from_numpy(field), torch.from_numpy(pos), K)
    pl = window_warp_field3_pallas(jnp.asarray(field), jnp.asarray(pos), K=K, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pl), atol=1e-4, rtol=0)
    xla = jf.sample_trilinear_window(jnp.asarray(field), jnp.asarray(pos), max_disp=K)
    np.testing.assert_allclose(_np(got), _np(xla), atol=2e-5, rtol=0)


@pytest.mark.parametrize("kind,amp", [("smooth", 3.5), ("outside", 6.0)])
@pytest.mark.parametrize("K", [None, 1, 2, 4])
def test_field3_plain_equals_b_plain_by_channel(K, kind, amp):
    """warp_field3's plain version bit for bit with three one-channel B plain
    warps: the kernel is held on the card to both."""
    field, pos = (torch.from_numpy(a) for a in _operands((17, 17, 17), kind, amp))
    got = kernels.warp_field3(field, pos, K)
    by_channel = torch.cat([kernels.warp(field[c:c + 1], pos, K, (False,)) for c in range(3)])
    assert torch.equal(got, by_channel)


def _launch_voxels(C, dims):
    """The (voxel index, x, y, z) each thread of csrc/warp.cu's launch for C
    channels writes, transcribed from voxel_of and launch_warpn."""
    Z, Y, X = dims
    per, tx, ty = kernels.WARP_LAUNCH[C]
    tile = kernels.TILE
    if tx == 0:
        blocks = -(-(-(-(Z * Y * X) // per)) // tile)
        b, t, j = np.meshgrid(np.arange(blocks), np.arange(tile), np.arange(per), indexing="ij")
        i = (b * tile * per + t + j * tile).ravel()
        i = i[i < Z * Y * X]
        row = i // X
        x, z = i - row * X, row // Y
        return i, x, row - z * Y, z
    tz = tile // (tx * ty)
    tiles_x, tiles_y = -(-X // tx), -(-Y // ty)
    blocks = tiles_x * tiles_y * -(-Z // (tz * per))
    b, t, j = np.meshgrid(np.arange(blocks), np.arange(tile), np.arange(per), indexing="ij")
    bx, r = b % tiles_x, b // tiles_x
    by, bz = r % tiles_y, r // tiles_y
    x = (bx * tx + t % tx).ravel()
    y = (by * ty + (t // tx) % ty).ravel()
    z = ((bz * per + j) * tz + t // (tx * ty)).ravel()
    ok = (x < X) & (y < Y) & (z < Z)
    x, y, z = x[ok], y[ok], z[ok]
    return (z * Y + y) * X + x, x, y, z


@pytest.mark.parametrize("dims", [(12, 16, 20), (7, 9, 13), (17, 17, 17), (5, 3, 40)])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_warp_launch_covers_every_voxel_once(C, dims):
    """Over the launch's grid every voxel is written exactly once, at its own
    (x, y, z): partial tiles on every axis, X under and over a tile's 32."""
    i, x, y, z = _launch_voxels(C, dims)
    n = int(np.prod(dims))
    assert np.array_equal(np.bincount(i, minlength=n), np.ones(n, np.int64))
    assert np.array_equal(np.stack([z, y, x]), np.stack(np.unravel_index(i, dims)))


def test_warp_launch_table_matches_the_source():
    """kernels.WARP_LAUNCH is csrc/warp.cu's launch_warpn: each channel
    count's (voxels a thread, tile width, tile depth), and a tile is one warp
    wide so that psi's loads and the stores stay coalesced."""
    src = open(os.path.join(ROOT, "sobfu_tpu_torch", "csrc", "warp.cu")).read()
    body = src[src.index("B's launch shape"):src.index("}  // namespace sobfu")]
    assert re.findall(r"kC == (\d)", body) == ["1", "2"]  # then the else: three
    shapes = re.findall(r"launch_warpn<kC, kMask, (\d+), (\d+), (\d+)>", body)
    table = {c: tuple(map(int, v)) for c, v in zip((1, 2, 3), shapes)}
    assert len(shapes) == 3 and table == kernels.WARP_LAUNCH
    assert all(tx in (0, 32) for _, tx, _ in table.values())


def test_smooth_displacement_is_smooth_bounded_and_seeded():
    """chip_smoke.smooth_displacement: within amp voxels and near it, a step
    of one voxel along an axis moves it by at most amp / 3 * 2 pi /
    wavelength (one of its three sines), the same seed gives the same field
    and another seed another."""
    d = smooth_displacement((32, 32, 32), 3.5, 1)
    assert d.shape == (3, 32, 32, 32) and d.dtype == np.float32
    assert 3.0 < np.abs(d).max() <= 3.5
    step = max(np.abs(np.diff(d, axis=a)).max() for a in (1, 2, 3))
    assert step <= 3.5 * 2 * np.pi / 32 / 3 + 1e-6
    assert np.array_equal(d, smooth_displacement((32, 32, 32), 3.5, 1))
    assert not np.array_equal(d, smooth_displacement((32, 32, 32), 3.5, 2))
