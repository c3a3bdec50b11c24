"""The scene-batched frame step on one device.

PyTorch counterpart of the single-device half of
``sobfu_tpu.parallel.sharding``: :func:`make_frame_step` integrates, solves
and fuses a batch of S independent scenes per call (over a ('scene', 'z')
mesh it returns :mod:`sobfu_tpu_torch.parallel.zshard`'s step). In the JAX package
this is the step on a one-device mesh (``n_scene = n_z = 1``), where
``jax.vmap`` runs the scenes' while_loops inside the device. Here the S
scenes share every iteration's launch of kernel A
(:func:`sobfu_tpu_torch.ops.kernels.gd_iteration_scenes`, driven in chunks
by :class:`sobfu_tpu_torch.ops.kernels.GdLoop`); the stop test runs per
scene on the device and the host reads the outcome once per chunk. A scene whose
predicate turns false keeps its state while the others go on, as under
vmap; the loop ends when no scene is active. The warps (B), the inverse
(C), the warp + fuse (D), the resamples and the integration run once per
scene, so a scene of a batch equals the same scene run alone bit for bit.

The z-sharded half (``make_mesh``, ``make_sharded_estimate_psi``,
``estimate_psi_sharded``, the halo exchange and the z-slab contract of the
fused kernel) is :mod:`sobfu_tpu_torch.parallel.zshard`. On one device the
K-halo of the z-block is the volume's edge replica, so the JAX package's
``_sample_window_local`` (the window sampler of the halo-extended volume at
shifted coordinates) takes the values of the port's window sampler on the
volume itself, up to the rounding of the shifted coordinate; the step here
samples the volume as it is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sobfu_tpu_torch import core, fields, pyramid
from sobfu_tpu_torch.ops import kernels
from sobfu_tpu_torch.tsdf import integrate_dists


def _downsample2_local(vol: torch.Tensor) -> torch.Tensor:
    """2x average-pool the last three axes (a mean over each 2x2x2 cell)."""
    sh = vol.shape
    Z, Y, X = sh[-3], sh[-2], sh[-1]
    v = vol.reshape(sh[:-3] + (Z // 2, 2, Y // 2, 2, X // 2, 2))
    return v.mean(dim=(-5, -3, -1))


def _upsample2_disp_local(disp: torch.Tensor, dims_zyx) -> torch.Tensor:
    """Trilinearly resample a displacement f32[3,Z,Y,X] to ``dims_zyx``
    (``jax.image.resize(..., "trilinear")``, :func:`pyramid.
    linear_resize_matrix`) and double its values."""
    return pyramid.resample_disp(disp, dims_zyx, 2.0)


def _per_scene(fn, *batches) -> torch.Tensor:
    """fn on each scene's slices of the batches, stacked on a scene axis."""
    return torch.stack([fn(*xs) for xs in zip(*batches)])


def _warp_scenes(vol: torch.Tensor, psi: torch.Tensor, K: Optional[int]) -> torch.Tensor:
    """Each scene's volume f32[S,Z,Y,X] sampled at its psi (kernel B)."""
    return _per_scene(lambda v, p: kernels.warp(v[None], p, K, (False,))[0], vol, psi)


def _gd_loop_scenes(psi, tg, live, taps, alpha, w_reg, max_iter, thresh, K, *,
                    momentum=None, stall_window=0, stall_rel=1e-3):
    """The batched GD while_loop of ``_gd_loop_local``: psi f32[S,3,Z,Y,X],
    tg and live f32[S,Z,Y,X].

    Scene s iterates while (it < max_iter) & (mnorm > thresh) & ~stalled;
    the stall test (stall_window > 0) compares A's energy 0.5 sum (tnp' -
    tg)^2, read on the host only at check iterations, with the previous
    check's. The scenes still active have all run the same number of
    iterations, so they share each check. The loop advances in chunks of up
    to ``kernels.GD_CHUNK`` iterations (``kernels.GdLoop``): the norm test
    runs per scene on the device, a scene that stops keeps its state, and
    the host reads the outcome once per chunk; a chunk ends at each stall
    check and at max_iter, so every count is the per-iteration loop's. Returns (psi, tnp, iters
    int32[S], mnorm float32[S]), the last two on the host.
    """
    dev = psi.device
    taps_t = torch.as_tensor(np.asarray(taps, np.float32), device=dev)
    alpha, w_reg = float(np.float32(alpha)), float(np.float32(w_reg))
    loop = kernels.GdLoop("gd_iteration_scenes", psi, _warp_scenes(live, psi, K), tg, live,
                          taps_t, alpha, w_reg, momentum, K, np.float32(thresh),
                          energy=bool(stall_window))
    it, mnorm = _run_chunks(loop, psi.shape[0], max_iter, thresh, stall_window, stall_rel)
    psi, tnp, _ = loop.state()
    return psi, tnp, it, mnorm


def _run_chunks(loop, S: int, max_iter: int, thresh, stall_window: int, stall_rel: float):
    """Drive a chunked loop (``kernels.GdLoop`` or ``kernels.GdSlabLoop``:
    ``run(n, active, with_energy) -> (done, max_sq rows, energy)``) over S
    scenes to the per-scene stop of the JAX while_loop; returns (iters
    int32[S], the last max norm float32[S])."""
    thresh, rel = np.float32(thresh), np.float32(stall_rel)
    it = np.zeros(S, np.int32)
    mnorm = np.full(S, np.inf, np.float32)
    e_ref = np.full(S, np.inf, np.float32)
    stalled = np.zeros(S, bool)
    while True:
        active = (it < max_iter) & (mnorm > thresh) & ~stalled
        if not active.any():
            break
        it0 = int(it[active][0])
        n = min(kernels.GD_CHUNK, max_iter - it0)
        if stall_window:
            n = min(n, stall_window - it0 % stall_window)
        at_check = bool(stall_window) and (it0 + n) % stall_window == 0
        done, rows, e_now = loop.run(n, active, with_energy=at_check)
        last = rows[np.maximum(done, 1) - 1, np.arange(S)]
        mnorm = np.where(active, np.sqrt(last), mnorm)
        it = it + done
        if at_check:
            ran = active & (done == n)  # the scenes that ran the check iteration
            stall = (it0 + n >= 2 * stall_window) & (e_ref - e_now < rel * np.abs(e_now))
            stalled = stalled | (ran & stall)
            e_ref = np.where(ran, e_now, e_ref)
    return it, mnorm


def _pyramid_warmstart_scenes(psi, tg, tn, taps, alpha, w_reg, thresh, K, levels,
                              coarse_its, momentum):
    """The coarse-to-fine warm start of ``_pyramid_warmstart_local``: every
    coarse level runs the plain windowed loop at the full window K, with no
    stall stop, to ``thresh * 0.5^L`` or ``coarse_its`` iterations; the
    incoming displacement is mean-pooled down, each level's result
    upsampled with its values doubled. (``solver.estimate_psi_pyramid``
    differs: resize pyramid, metric-scaled window, kernel E.) Returns (psi
    warm-started at full resolution, int32[S] coarse iterations)."""
    dev = psi.device
    pyr = [(tg, tn)]
    for _ in range(levels - 1):
        a, b = pyr[-1]
        pyr.append((_per_scene(_downsample2_local, a), _per_scene(_downsample2_local, b)))
    ident0 = fields.identity_field(psi.shape[-3:], device=dev)
    disp = _per_scene(_downsample2_local, psi - ident0)
    for _ in range(levels - 2):
        disp = _per_scene(_downsample2_local, disp)
    disp = disp * float(np.float32(1.0 / 2 ** (levels - 1)))
    total = np.zeros(psi.shape[0], np.int32)
    for lev in range(levels - 1, 0, -1):
        tg_c, tn_c = pyr[lev]
        ident_c = fields.identity_field(tg_c.shape[-3:], device=dev)
        thresh_c = np.float32(thresh) * np.float32(0.5 ** lev)
        psi_c, _, it_c, _ = _gd_loop_scenes(ident_c + disp, tg_c, tn_c, taps, alpha, w_reg,
                                            coarse_its, thresh_c, K, momentum=momentum)
        total = total + it_c
        up = tuple(pyr[lev - 1][0].shape[-3:])
        disp = _per_scene(lambda d: _upsample2_disp_local(d, up), psi_c - ident_c)
    return ident0 + disp, total


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class StepInputs(NamedTuple):
    """A frame step's arguments: the arrays as float32 tensors on the step's
    device, the rest as host values."""

    psi: torch.Tensor
    tg: torch.Tensor
    wg: torch.Tensor
    dists: torch.Tensor
    psi_inv0: Optional[torch.Tensor]
    v2c: np.ndarray
    intr: tuple
    vsz: tuple
    trunc: float
    eta: float
    max_weight: float
    taps: np.ndarray
    alpha: float
    w_reg: float
    max_iter: int
    thresh: np.float32


def _step_inputs(dims, dev, warm_inverse: bool, psi_b, tg_b, wg_b, dists_b, vol2cam_b, intr,
                 voxel_sizes, trunc, eta, max_weight, taps, alpha, w_reg, max_iter, thresh,
                 psi_inv0_b) -> StepInputs:
    """Check and convert a frame step's arguments (see :class:`FrameStep`)."""
    if (psi_inv0_b is not None) != warm_inverse:
        raise TypeError("psi_inv0_b is passed exactly when the step has warm_inverse")

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()

    def floats(a):
        return tuple(float(v) for v in _host(a).astype(np.float32))

    psi = t(psi_b)
    S = psi.shape[0]
    if tuple(psi.shape) != (S, 3) + dims:
        raise ValueError(f"psi_b: shape {tuple(psi.shape)}, expected (S, 3) + {dims}")
    trunc, eta, max_weight = (float(_host(a)) for a in (trunc, eta, max_weight))
    return StepInputs(
        psi, t(tg_b), t(wg_b), t(dists_b), None if psi_inv0_b is None else t(psi_inv0_b),
        _host(vol2cam_b).astype(np.float32), floats(intr), floats(voxel_sizes), trunc, eta,
        max_weight, _host(taps).astype(np.float32), float(_host(alpha)), float(_host(w_reg)),
        int(_host(max_iter)), np.float32(_host(thresh)))


class FrameStep:
    """The step of :func:`make_frame_step`:

        step(psi_b, tg_b, wg_b, dists_b, vol2cam_b, intr, voxel_sizes, trunc,
             eta, max_weight, taps, alpha, w_reg, max_iter, thresh
             [, psi_inv0_b])
          -> (psi_b, psi_inv_b, tg_b, wg_b, iters_b, mnorm_b)

    psi_b f32[S,3,Z,Y,X], volumes f32[S,Z,Y,X], dists f32[S,H,W], vol2cam
    f32[S,4,4], intr (fx, fy, cx, cy); psi_inv0_b (f32[S,3,Z,Y,X]) is given
    exactly when the step was made with warm_inverse. Arrays are moved to
    the step's device; the fields and volumes come back on it, iters_b
    (int32[S], coarse levels included) and mnorm_b (float32[S], the fine
    loop's last max norm) on the host. ``coarse_iters`` holds the last
    call's coarse-level iterations per scene.
    """

    def __init__(self, dims_zyx, device, **opts):
        self.dims = tuple(int(d) for d in dims_zyx)
        self.device = device
        self.opts = opts
        self.coarse_iters = np.zeros(0, np.int32)

    def __call__(self, psi_b, tg_b, wg_b, dists_b, vol2cam_b, intr, voxel_sizes, trunc, eta,
                 max_weight, taps, alpha, w_reg, max_iter, thresh, psi_inv0_b=None):
        o = self.opts
        dev = self.device
        psi, tg, wg, dists, psi_inv0, v2c, intr, vsz, trunc, eta, max_weight, taps, alpha, \
            w_reg, max_iter, thresh = _step_inputs(
                self.dims, dev, o["warm_inverse"], psi_b, tg_b, wg_b, dists_b, vol2cam_b, intr,
                voxel_sizes, trunc, eta, max_weight, taps, alpha, w_reg, max_iter, thresh,
                psi_inv0_b)
        S = psi.shape[0]
        K = o["warp_window"]

        # each scene integrated from zero volumes (its live TSDF and weight)
        zero = torch.zeros(self.dims, dtype=torch.float32, device=dev)
        live = [integrate_dists(zero, zero, dists[s], v2c[s], intr, vsz, trunc, eta,
                                axis_aligned=o["axis_aligned"]) for s in range(S)]
        tn = torch.stack([a for a, _ in live])
        wn = torch.stack([b for _, b in live])

        coarse = np.zeros(S, np.int32)
        if o["pyramid_levels"] > 1 and K is not None:
            c_its = o["coarse_max_iter"] if o["coarse_max_iter"] is not None else max_iter
            psi, coarse = _pyramid_warmstart_scenes(psi, tg, tn, taps, alpha, w_reg, thresh, K,
                                                    o["pyramid_levels"], int(c_its),
                                                    o["momentum"])
        fine_taps = o["taps_static"] if o["fused"] else taps
        loop = dict(momentum=o["momentum"], stall_window=o["stall_window"],
                    stall_rel=o["stall_rel"])
        Kf = o["fine_window"]
        if Kf is not None:
            # compositive fine level: T0 = live o psi0 in the window K, the
            # increment loop from the identity at Kf, psi = psi0 o g (B, C=3)
            t0 = _warp_scenes(tn, psi, K)
            ident = fields.identity_field(self.dims, device=dev).expand(S, -1, -1, -1, -1)
            g, tnp, iters, mnorm = _gd_loop_scenes(ident.contiguous(), tg, t0, fine_taps, alpha,
                                                   w_reg, max_iter, thresh, Kf, **loop)
            psi = _per_scene(lambda p, q: kernels.warp_field3(p, q, Kf), psi, g)
        else:
            psi, tnp, iters, mnorm = _gd_loop_scenes(psi, tg, tn, fine_taps, alpha, w_reg,
                                                     max_iter, thresh, K, **loop)
        self.coarse_iters = coarse

        inits = [None] * S if psi_inv0 is None else list(psi_inv0)
        psi_inv = torch.stack([kernels.inverse_fixed_point(psi[s], o["inverse_iters"], K, init)
                               for s, init in enumerate(inits)])
        fused = [kernels.warp_fuse(tg[s], wg[s], tnp[s], wn[s], psi[s], max_weight, K)
                 for s in range(S)]
        return (psi, psi_inv, torch.stack([a for a, _ in fused]),
                torch.stack([b for _, b in fused]), torch.as_tensor(iters + coarse),
                torch.as_tensor(mnorm))


def make_frame_step(
    dims_zyx: Tuple[int, int, int], *,
    inverse_iters: int = 8,
    warp_window: Optional[int] = None,
    fused: bool = False,
    taps_static=None,
    momentum: Optional[float] = None,
    warm_inverse: bool = False,
    pyramid_levels: int = 1,
    coarse_max_iter: Optional[int] = None,
    fine_window: Optional[int] = None,
    stall_window: int = 0,
    stall_rel: float = 1e-3,
    fold_xmats: bool = False,
    axis_aligned: bool = False,
    device="cuda",
    mesh=None,
):
    """One frame step (integrate -> solve -> fuse) over a batch of scenes
    (``sobfu_tpu.parallel.make_frame_step``). Without ``mesh``, on one
    device (``device``, the card by default): the JAX step on a one-device
    mesh. With a ('scene', 'z') mesh from :func:`make_mesh`, the scenes
    split over its scene rows and each volume over its z-slabs
    (:class:`sobfu_tpu_torch.parallel.zshard.ShardedFrameStep`; ``device``
    is then unused).

    Options as in JAX: fused (the JAX package's per-shard fused kernel;
    needs warp_window and taps_static, and the fine loop then takes
    taps_static; here both paths run kernel A), momentum (heavy ball),
    warm_inverse (the step takes psi_inv0_b), pyramid_levels /
    coarse_max_iter (the coarse-to-fine warm start of
    :func:`_pyramid_warmstart_scenes`; only with warp_window),
    fine_window (a compositive fine level; needs warp_window) and
    stall_window / stall_rel (the fine loop's data-energy stall stop).
    warp_window None is the exact mode: exact warps, the exact inverse and
    the exact floor warp. fold_xmats selects the TPU's MXU x-operators and
    is accepted and ignored. axis_aligned: every scene's vol2cam is
    rotation-free (the direct-index integration).
    """
    del fold_xmats  # a TPU layout choice: nothing to select here
    dims = tuple(int(d) for d in dims_zyx)
    n_z = 1 if mesh is None else mesh.shape["z"]
    if dims[0] % n_z:
        raise ValueError(f"a {dims[0]}-deep grid does not split into {n_z} z-slabs")
    depth = dims[0] // n_z
    fewer = " or z-shards" if n_z > 1 else ""
    if depth < 4:
        raise ValueError(f"z extent {depth} smaller than the halo radius 4; use fewer z-shards "
                         f"for a {dims[0]}-deep grid")
    if pyramid_levels > 1 and depth // 2 ** (pyramid_levels - 1) < 4:
        raise ValueError(f"coarsest z extent {depth // 2 ** (pyramid_levels - 1)} smaller "
                         f"than the halo radius 4; use fewer pyramid levels{fewer}")
    if fused and (warp_window is None or taps_static is None):
        raise ValueError("fused needs warp_window and taps_static")
    if fine_window is not None and warp_window is None:
        raise ValueError("fine_window requires warp_window")
    if mesh is None:
        make, where = FrameStep, core.resolve_device(device)
    else:
        from sobfu_tpu_torch.parallel.zshard import ShardedFrameStep

        make, where = ShardedFrameStep, mesh
    return make(
        dims, where,
        inverse_iters=int(inverse_iters), warp_window=warp_window, fused=bool(fused),
        taps_static=None if taps_static is None else np.asarray(taps_static, np.float32),
        momentum=momentum, warm_inverse=bool(warm_inverse),
        pyramid_levels=int(pyramid_levels), coarse_max_iter=coarse_max_iter,
        fine_window=fine_window, stall_window=int(stall_window), stall_rel=float(stall_rel),
        axis_aligned=bool(axis_aligned),
    )
