"""The frame's front end on the CPU (sobfu_tpu_torch/ops/frontend.py): the
plain versions of kernels P and I against the chain and the integration
they replace and against the JAX package, and the frame step's hooks.

On the CPU the wrappers run the plain versions; the kernels themselves are
held to them on the card (tests/test_torch_cuda.py -k frontend).
"""

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sobfu_tpu import tsdf as jt
from sobfu_tpu.ops import imgproc as ji
from sobfu_tpu_torch import pipeline, tsdf
from sobfu_tpu_torch.config import Intr, Params, translation_pose
from sobfu_tpu_torch.ops import frontend, imgproc, kernels

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from make_synthetic_scene import render_prims_depth  # noqa: E402

SIGMAS = (4.5, 0.04)


def _intr(H, W):
    return Intr(60.0, 60.0, W / 2 - 0.5, H / 2 - 0.5)


def _depth(H, W, seed):
    """uint16 mm: two spheres before a wall at 0.9 m, 2 mm of noise and 3%
    holes (some on the last row and column among far neighbours, where the
    filter's weights all underflow)."""
    d = render_prims_depth(H, W, *_intr(H, W), [((0.0, 0.0, 0.5), 0.12),
                                                 ((0.05, -0.03, 0.38), 0.03)])
    d = np.where(d > 0, d, 900.0).astype(np.float64)
    rng = np.random.default_rng(seed)
    d += rng.normal(0.0, 2.0, d.shape)
    d[rng.random(d.shape) < 0.03] = 0.0
    return np.clip(np.round(d), 0, 65535).astype(np.uint16)


def _old_preprocess(depth, k, sigma_spatial, sigma_depth, max_dist, intr):
    """``pipeline.preprocess`` before the front end had kernels: the three
    functions chained."""
    filtered = imgproc.bilateral_filter(depth, k, sigma_spatial, sigma_depth)
    if max_dist > 0:
        filtered = imgproc.truncate_depth(filtered, max_dist)
    return imgproc.compute_dists(filtered, intr)


CASES = [(H, W, k, cut) for H, W in ((37, 53), (48, 64)) for k in (3, 5, 7)
         for cut in (0.0, 0.7)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("H,W,k,cut", CASES)
def test_preprocess_plain_is_the_old_chain(H, W, k, cut, seed):
    """preprocess_depth_plain, the wrapper on a CPU tensor and
    pipeline.preprocess are bit for bit the chained filter, truncation and
    ray lengths."""
    depth = torch.from_numpy(_depth(H, W, seed).astype(np.int32))
    args = (depth, k, *SIGMAS, cut, _intr(H, W))
    want = _old_preprocess(*args)
    assert torch.equal(frontend.preprocess_depth_plain(*args), want)
    assert torch.equal(frontend.preprocess_depth(*args), want)
    p = Params()
    p.bilateral_kernel_size, p.icp_truncate_depth_dist, p.intr = k, cut, _intr(H, W)
    p.bilateral_sigma_spatial, p.bilateral_sigma_depth = SIGMAS
    assert torch.equal(pipeline.preprocess(depth, p), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("H,W", [(37, 53), (48, 64)])
def test_preprocess_plain_matches_jax_chain(H, W, k, seed):
    """Against sobfu_tpu's bilateral_filter -> truncate_depth ->
    compute_dists. The filtered mm are equal (the 0 / 0 windows included)
    but on at most one pixel a map, 1 mm apart: XLA's and torch's exp differ
    by an ulp on some inputs, which moves a mean that sits at half a mm (5
    pixels in 436,194 over 54 such maps, all 1 mm). The dists, where the mm
    agree, within 3e-7 relative: the same elementwise float32 operations,
    which XLA fuses or reorders (measured on these 18 maps from the same mm:
    up to 3 ulps, 2.33e-7 relative)."""
    d = _depth(H, W, seed)
    intr = _intr(H, W)
    jm = ji.truncate_depth(ji.bilateral_filter(jnp.asarray(d), k, *SIGMAS), jnp.float32(0.7))
    want = np.asarray(ji.compute_dists(jm, jnp.asarray(intr, jnp.float32)))
    mm = imgproc.truncate_depth(
        imgproc.bilateral_filter(torch.from_numpy(d.astype(np.int32)), k, *SIGMAS), 0.7)
    diff = np.abs(mm.numpy().astype(np.int64) - np.asarray(jm).astype(np.int64))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= 1
    got = frontend.preprocess_depth_plain(torch.from_numpy(d.astype(np.int32)), k, *SIGMAS,
                                          0.7, intr)
    same = diff == 0
    np.testing.assert_allclose(got.numpy()[same], want[same], rtol=3e-7, atol=0)


def _integrate_args(aligned, z_offset, dims=(12, 16, 20)):
    H, W = 48, 64
    dists = frontend.preprocess_depth_plain(torch.from_numpy(_depth(H, W, 3).astype(np.int32)),
                                            5, *SIGMAS, 0.0, _intr(H, W))
    vs = (0.4 / dims[2], 0.4 / dims[1], 0.4 / dims[0])
    m = np.asarray(translation_pose((-0.2, -0.2, 0.25)), np.float32)
    if not aligned:
        a = np.deg2rad(4.0)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    rng = np.random.default_rng(5)
    t0 = torch.as_tensor(rng.uniform(-1, 1, dims), dtype=torch.float32)
    w0 = torch.as_tensor(rng.integers(0, 3, dims), dtype=torch.float32)
    return (t0, w0, dists, m, _intr(H, W), vs, 6 * vs[0], 2 * vs[0], aligned, z_offset)


@pytest.mark.parametrize("aligned", [True, False], ids=["axis-aligned", "rotated"])
@pytest.mark.parametrize("z_offset", [0, 6])
def test_integrate_dists_on_cpu_unchanged(aligned, z_offset):
    """tsdf.integrate_dists on CPU tensors is its plain version bit for bit,
    in both branches and on a z-slab, and matches the JAX package's: bit for
    bit on the axis-aligned branch; rotated, the einsum's sum order may move
    a projection across a pixel edge (tests/test_torch_tsdf.py's rule: 1e-5
    on all but 0.5% of the voxels)."""
    args = _integrate_args(aligned, z_offset)
    got = tsdf.integrate_dists(*args)
    want = frontend.integrate_dists_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[1] != args[1]).sum()) > 100  # the frame was seen
    t0, w0, dists, m, intr, vs, trunc, eta = args[:8]
    j = jt.integrate_dists(jnp.asarray(t0.numpy()), jnp.asarray(w0.numpy()),
                           jnp.asarray(dists.numpy()), jnp.asarray(m),
                           jnp.asarray(intr, jnp.float32), jnp.asarray(vs, jnp.float32),
                           jnp.float32(trunc), jnp.float32(eta), tuple(t0.shape), z_offset,
                           axis_aligned=aligned)
    jt_, jw = np.asarray(j[0]), np.asarray(j[1])
    if aligned:
        np.testing.assert_array_equal(got[0].numpy(), jt_)
        np.testing.assert_array_equal(got[1].numpy(), jw)
    else:
        bad = (np.abs(got[0].numpy() - jt_) > 1e-5) | (got[1].numpy() != jw)
        assert bad.mean() <= 5e-3


def _fusion_params(dim=16):
    p = Params()
    p.volume_dims, p.volume_size = (dim,) * 3, (0.4, 0.4, 0.4)
    p.volume_pose = translation_pose((-0.2, -0.2, 0.25))
    p.intr = Intr(60.0, 60.0, 31.5, 23.5)
    p.tsdf_trunc_dist, p.eta = 6.0 * 0.4 / dim, 3.0 * 0.4 / dim
    p.bilateral_kernel_size, p.start_frame = 5, 1
    p.max_iter, p.max_update_norm, p.alpha, p.w_reg, p.warp_window = 4, 1e-6, 0.1, 0.2, 2
    return p


def test_frame_step_calls_the_front_end_through_module_attributes(monkeypatch):
    """fused_frame_step reaches preprocess and integrate_dists as
    pipeline's module attributes, the hooks the benchmark's spans, its live
    volume and the bfloat16 control patch: patched with counters, one 16^3
    frame calls each once."""
    frames = [render_prims_depth(48, 64, 60.0, 60.0, 31.5, 23.5,
                                 [((0.004 * i, 0.0, 0.45), 0.08)]) for i in range(2)]
    fusion = pipeline.SobFusion(_fusion_params(), device="cpu")
    fusion.need_inv_warps = False
    fusion(frames[0])
    calls = {"preprocess": 0, "integrate_dists": 0}

    def counted(name):
        fn = getattr(pipeline, name)

        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)

        return call

    for name in calls:
        monkeypatch.setattr(pipeline, name, counted(name))
    fusion(frames[1])
    assert calls == {"preprocess": 1, "integrate_dists": 1}
    assert fusion.last_solve is not None and float(fusion.phi_n.weight.sum()) > 0


def test_launch_counts_kept_apart():
    """kernels.launch_counts holds the nine kernels the benchmark knows; the
    front end is counted in frontend.launch_counts alone, a CPU call counts
    nothing, and no CUDA name of P or I contains a name the benchmark's trace
    books under another kernel."""
    from benchmark import trace

    nine = {"gd_iteration", "warp", "inverse_fixed_point", "warp_fuse", "gd_multi",
            "compose_weight", "warp_field3", "gd_iteration_scenes", "gd_iteration_slab"}
    assert set(kernels.launch_counts) == nine == set(kernels.KERNELS)
    assert set(frontend.launch_counts) == set(frontend.KERNELS) == {"preprocess_depth",
                                                                    "integrate_dists"}
    kernels.reset_launch_counts()
    frontend.reset_launch_counts()
    args = _integrate_args(True, 0)
    frontend.integrate_dists(*args)
    frontend.preprocess_depth(torch.zeros((8, 8), dtype=torch.int32), 3, *SIGMAS, 0.0,
                              _intr(8, 8))
    assert set(frontend.launch_counts.values()) == {0}
    assert set(kernels.launch_counts.values()) == {0}
    for source, _ in frontend.KERNELS.values():
        text = open(os.path.join(ROOT, source)).read()
        names = re.findall(r"__global__ void (\w+)", text)
        assert names
        for name in names:
            assert trace.port_kernel(name) is None, name


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA card raises."""
    meta = torch.empty((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        frontend.preprocess_depth(meta, 3, *SIGMAS, 0.0, _intr(4, 4))
    vol = torch.empty((2, 2, 2), device="meta")
    with pytest.raises(ValueError):
        frontend.integrate_dists(vol, vol, vol[0], np.eye(4), _intr(4, 4), (0.1,) * 3, 0.3,
                                 0.1)
