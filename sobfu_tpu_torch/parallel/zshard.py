"""The z-sharded solve and frame step over a ('scene', 'z') mesh of devices.

PyTorch counterpart of the z-sharded half of ``sobfu_tpu.parallel.sharding``:
:func:`make_mesh`, the halo exchange and its stencils,
:func:`make_sharded_estimate_psi`, :func:`estimate_psi_sharded` and the
frame step over a mesh (``make_frame_step(..., mesh=)``). The JAX package
runs this as one program (``shard_map``) over the devices of one process;
here one process drives a mesh of torch devices. A sharded volume is a list
of z-slabs in z order, slab j on the mesh device of z index j, each with a
leading scene axis; the collectives are functions over that list:
``ppermute`` (the halo exchange) copies rows between neighbouring slabs,
``pmax`` and ``psum`` are reductions in this process, ``all_gather``
concatenates the slabs. A mesh may name one device several times
(``[torch.device("cuda")] * 4`` on one card, ``["cpu"] * 4`` in the tests):
every copy, reduction and launch then runs for real on that device.

The GD loop runs kernel A's slab form (``kernels.GdSlabLoop`` over card
groups, the runs of consecutive slabs on one device: a launch per group and
iteration, all the slabs of a card in one launch reading their neighbours'
rows in place, the halo rows of psi and tnp copied only between cards, the
stop test over all slabs on the device, one host read per chunk; on one card
one call a chunk; :func:`make_mesh`'s default, one slab a card, makes each
slab a group) wherever the JAX package runs its fused per-shard kernel,
and on the pyramid's coarse levels, where JAX runs plain XLA steps of the
same numbers.
Without ``fused`` the fine loop runs :func:`_gd_step_local`, the plain torch
step (the host tests the stop after each iteration). The tails (the inverse
fixed point, the warps of tg, wg and wn, the fuse) are plain torch on the
slabs, as JAX runs them in XLA. The mesh counts the bytes the halo
exchanges copy and the whole-volume gathers (the exact mode's five a solve,
none in the windowed mode).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from sobfu_tpu_torch import core, fields, tsdf
from sobfu_tpu_torch.ops import kernels
from sobfu_tpu_torch.parallel import sharding
from sobfu_tpu_torch.parallel.sharding import _per_scene

# the halo of the GD step: stencil radius 1 + convolution radius 3
H = kernels.SLAB_HALO


class Mesh:
    """A ('scene', 'z') grid of torch devices: ``devices[r][j]`` holds z-slab
    j of the scenes of scene-shard r. Counts, from 0 or the last
    :meth:`reset_counts`: ``halo_bytes`` copied between slabs by the halo
    exchanges, of which ``loop_halo_bytes`` by the GD loops over
    ``loop_iterations`` iterations (the fused loop copies rows only between
    card groups: none where the mesh's z axis is one card); ``gathers``, the
    whole volumes gathered from all slabs."""

    def __init__(self, devices: List[List[torch.device]]):
        self.devices = devices
        self.shape = {"scene": len(devices), "z": len(devices[0])}
        self.reset_counts()

    def reset_counts(self) -> None:
        self.halo_bytes = self.loop_halo_bytes = self.loop_iterations = self.gathers = 0


def _device(d) -> torch.device:
    dev = core.resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_z: Optional[int] = None, n_scene: int = 1, devices=None) -> Mesh:
    """A ('scene', 'z') mesh of n_scene x n_z devices (``sobfu_tpu.parallel.
    make_mesh``); n_z defaults to all of them. devices defaults to every
    visible card; a list may name a device more than once. Without a card
    the caller passes CPU devices: nothing falls back to the CPU."""
    if devices is None:
        if core.get_device_count() == 0:
            core.resolve_device("cuda")  # raises: no card
        devices = [f"cuda:{i}" for i in range(core.get_device_count())]
    devs = [_device(d) for d in devices]
    if n_z is None:
        n_z = len(devs) // n_scene
    if n_scene < 1 or n_z < 1 or n_scene * n_z > len(devs):
        raise ValueError(f"a {n_scene} x {n_z} mesh needs {n_scene * n_z} devices, "
                         f"got {len(devs)}")
    return Mesh([devs[r * n_z:(r + 1) * n_z] for r in range(n_scene)])


# ---------------------------------------------------------------------------
# halo exchange + halo-aware stencils
# ---------------------------------------------------------------------------


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """t on dev. Between two cards torch's copy is ordered after the current
    streams of both (an event recorded on each side)."""
    return t if t.device == dev else t.to(dev)


def _halo_exchange_z(xs, h: int, mesh: Optional[Mesh] = None):
    """Each slab f32[..., Zl, Y, X] padded with h rows of each neighbour
    (axis -3, copied by ``kernels._exchange_rows``); the end slabs replicate
    their edge row on the volume's side (the reference's clamp-to-edge
    stencils, solver.cu:246-270)."""
    out = []
    for x in xs:
        Zl = x.shape[-3]
        if h > Zl:
            raise ValueError(f"a halo of {h} rows exceeds the {Zl}-row z-slab")
        rep = [1] * x.dim()
        rep[-3] = h
        out.append(torch.cat([x[..., :1, :, :].repeat(*rep), x,
                              x[..., Zl - 1:, :, :].repeat(*rep)], dim=-3))
    moved = kernels._exchange_rows(out, h)
    if mesh is not None:
        mesh.halo_bytes += moved
    return out


def _all_gather(xs, mesh: Optional[Mesh] = None):
    """Each slab's copy of the whole volume (the slabs concatenated along
    axis -3), made once per device."""
    whole = {}
    for x in xs:
        if x.device not in whole:
            whole[x.device] = torch.cat([_to(y, x.device) for y in xs], dim=-3)
    if mesh is not None:
        mesh.gathers += 1
    return [whole[x.device] for x in xs]


def _central_diff_z_halo(xp, h: int, zmask):
    """d/dz on a halo-padded slab -> slab-sized, zero at the volume's ends."""
    n_local = xp.shape[-3] - 2 * h
    up = xp[..., h + 1:h + 1 + n_local, :, :]
    dn = xp[..., h - 1:h - 1 + n_local, :, :]
    return (up - dn) * 0.5 * zmask


def _second_diff_z_halo(xp, h: int, zmask):
    n_local = xp.shape[-3] - 2 * h
    up = xp[..., h + 1:h + 1 + n_local, :, :]
    mid = xp[..., h:h + n_local, :, :]
    dn = xp[..., h - 1:h - 1 + n_local, :, :]
    return (up + dn - 2.0 * mid) * zmask


def _conv_z_halo(xp, taps, h: int):
    """z-convolution reading radius r of the h-halo -> slab-sized. The sum
    is rounded as XLA's CPU backend rounds the JAX package's: tap 0's
    product added to tap 1's in one multiply-add, then each further tap
    multiply-added (torch.addcmul)."""
    s = taps.shape[0]
    r = s // 2
    n_local = xp.shape[-3] - 2 * h

    def sl(u):
        return xp[..., h + r - u:h + r - u + n_local, :, :]

    if s == 1:
        return taps[0] * sl(0)
    out = torch.addcmul(taps[1] * sl(1), taps[0], sl(0))
    for u in range(2, s):
        out = torch.addcmul(out, taps[u], sl(u))
    return out


def _zmask(n_local: int, is_first: bool, is_last: bool, dtype=torch.float32, device=None):
    """1 everywhere but the volume's end rows (the stencils vanish there,
    vector_fields.cu:165-191); f32[n_local, 1, 1]."""
    m = torch.ones((n_local, 1, 1), dtype=dtype, device=device)
    if is_first:
        m[0] = 0.0
    if is_last:
        m[-1] = 0.0
    return m


# ---------------------------------------------------------------------------
# the sharded GD step and loop
# ---------------------------------------------------------------------------


def _sample_window_local(vol_e, coords_l, z0: int, K: int, floor: bool = False):
    """Window sampling of a slab from its K-halo-extended volume vol_e
    [..., Zl+2K, Y, X] at the global coordinates coords_l f32[3, Zl, Y, X]:
    the z coordinate shifted by z0 - K in float32 into the extended frame
    (the JAX package's rounding; the edge-replicated halos at the volume's
    ends make the local clamp the global one)."""
    p = coords_l.clone()
    p[2] = coords_l[2] + float(-(np.float32(z0) - np.float32(K)))
    fn = (fields.sample_nearest_floor_window_zoffset if floor
          else fields.sample_trilinear_window_zoffset)
    return fn(vol_e, p, K, K)


def _ident(dims_zyx, z0: int, device) -> torch.Tensor:
    """The identity of a slab whose row 0 is global row z0 (global coordinates)."""
    ident = fields.identity_field(dims_zyx, device=device)
    ident[2] += float(z0)
    return ident


def _gd_step_local(psi_l, tnp_l, tg_l, src_l, taps, alpha, w_reg, z0s, mesh=None, K=None,
                   vel_l=None, momentum=None):
    """One plain gradient-descent step of one scene on all its z-slabs
    (lists in z order of f32[3, Zl, Y, X] and f32[Zl, Y, X]): the halo
    exchanges of psi, tnp and dU, the halo stencils and the z-convolution,
    the step, and the re-warp from src_l (each slab's copy of the whole live
    volume for K None, its K-halo-extended slab otherwise). Returns (psi_l,
    tnp_l, vel_l, max_sq): max_sq is the max squared update norm over every
    slab (the JAX step returns its root, the pmax of the slabs' norms)."""
    n = len(psi_l)
    psi_p = _halo_exchange_z(psi_l, H, mesh)
    tnp_p = _halo_exchange_z(tnp_l, H, mesh)
    dU = []
    for j in range(n):
        zmask = _zmask(psi_l[j].shape[-3], j == 0, j == n - 1, device=psi_l[j].device)
        grad = torch.stack([fields.central_diff(tnp_l[j], -1), fields.central_diff(tnp_l[j], -2),
                            _central_diff_z_halo(tnp_p[j], H, zmask)])
        lap = -(fields.second_diff(psi_l[j], -1) + fields.second_diff(psi_l[j], -2)
                + _second_diff_z_halo(psi_p[j], H, zmask))
        dU.append((tnp_l[j] - tg_l[j])[None] * grad + w_reg * lap)
    dU_p = _halo_exchange_z(dU, H, mesh)
    psi_o, tnp_o, vel_o, max_sq = [], [], [], []
    for j in range(n):
        t = _to(taps, psi_l[j].device)
        conv = fields.conv1d_replicate
        dU_S = conv(dU[j], t, -1) + conv(dU[j], t, -2) + _conv_z_halo(dU_p[j], t, H)
        if momentum is not None:
            vel_new = momentum * vel_l[j] + dU_S
            update = alpha * vel_new
        else:
            vel_new = None
            update = alpha * dU_S
        psi_new = psi_l[j] - update
        if K is None:
            tnp_new = fields.sample_trilinear(src_l[j], psi_new)
        else:
            tnp_new = _sample_window_local(src_l[j], psi_new, z0s[j], K)
        psi_o.append(psi_new)
        tnp_o.append(tnp_new)
        vel_o.append(vel_new)
        max_sq.append(float(torch.max(torch.sum(update * update, dim=0))))
    return psi_o, tnp_o, vel_o, np.float32(np.max(max_sq))


class _StepLoop:
    """The unfused sharded loop, :func:`_gd_step_local` per iteration and
    running scene, with the ``run`` / ``state`` of ``kernels.GdLoop``; the
    host tests the stop after every iteration."""

    def __init__(self, psi_l, tnp_l, tg_l, src_l, taps, alpha, w_reg, z0s, mesh, K, momentum,
                 thresh):
        S = psi_l[0].shape[0]
        zero = (lambda p: torch.zeros_like(p)) if momentum is not None else (lambda p: None)
        self.state_s = [([p[s] for p in psi_l], [t[s] for t in tnp_l],
                         [zero(p[s]) for p in psi_l]) for s in range(S)]
        self.tg = [[t[s] for t in tg_l] for s in range(S)]
        self.src = [[v[s] for v in src_l] for s in range(S)]
        self.args = (taps, alpha, w_reg, z0s, mesh, K)
        self.momentum, self.thresh = momentum, np.float32(thresh)

    def run(self, n: int, active, with_energy: bool = False):
        on = np.asarray(active, bool).copy()
        S = on.shape[0]
        done = np.zeros(S, np.int32)
        rows = np.zeros((n, S), np.float32)
        e = np.zeros(S, np.float32) if with_energy else None
        for k in range(n):
            if k:
                on &= np.sqrt(rows[k - 1]) > self.thresh
            if not on.any():
                break
            for s in np.flatnonzero(on):
                psi, tnp, vel = self.state_s[s]
                psi, tnp, vel, rows[k, s] = _gd_step_local(psi, tnp, self.tg[s], self.src[s],
                                                           *self.args, vel, self.momentum)
                self.state_s[s] = (psi, tnp, vel)
                if with_energy and k == n - 1:  # 0.5 psum sum (tnp - tg)^2
                    e[s] = np.float32(0.5) * np.sum(
                        [float(torch.sum((t - g) * (t - g))) for t, g in zip(tnp, self.tg[s])],
                        dtype=np.float32)
            done += on
        return done, rows, e

    def state(self):
        """Per slab, (psi f32[S,3,Zl,Y,X], tnp f32[S,Zl,Y,X], None)."""
        return [(torch.stack([st[0][j] for st in self.state_s]),
                 torch.stack([st[1][j] for st in self.state_s]), None)
                for j in range(len(self.state_s[0][0]))]


def _gd_loop_local(psi_l, tg_l, live_l, live_src, taps, alpha, w_reg, max_iter, thresh, z0s,
                   mesh, K, *, fused=False, momentum=None, stall_window=0, stall_rel=1e-3):
    """The GD while_loop on the z-slabs of S scenes (``_gd_loop_local``):
    psi_l, tg_l, live_l lists in z order of f32[S,3,Zl,Y,X] / f32[S,Zl,Y,X];
    live_src the warp source (each slab's copy of the whole live volume for
    K None, its K-halo-extended slab otherwise). Scene s iterates while
    (it < max_iter) & (max norm over all slabs > thresh) & ~stalled, the
    stall energy summed over the slabs (the psum). fused: kernel A's slab
    form (``kernels.GdSlabLoop``), else :func:`_gd_step_local`. Returns
    (psi_l, tnp_l, iters int32[S], mnorm float32[S]); the last two on the
    host."""
    S = psi_l[0].shape[0]
    taps_t = torch.as_tensor(np.asarray(taps, np.float32), device=psi_l[0].device)
    alpha, w_reg = float(np.float32(alpha)), float(np.float32(w_reg))
    if K is None:
        tnp0 = [_per_scene(fields.sample_trilinear, src, p) for src, p in zip(live_src, psi_l)]
    else:
        tnp0 = [_per_scene(lambda v, p, z0=z0: _sample_window_local(v, p, z0, K), src, p)
                for src, p, z0 in zip(live_src, psi_l, z0s)]
    if fused:
        z_global = sum(p.shape[-3] for p in psi_l)
        live = live_src if K is None else _halo_exchange_z(live_l, H, mesh)
        loop = kernels.GdSlabLoop(psi_l, tnp0, _halo_exchange_z(tg_l, H, mesh), live, taps_t,
                                  alpha, w_reg, momentum, K, np.float32(thresh), z_global,
                                  energy=bool(stall_window))
    else:
        loop = _StepLoop(psi_l, tnp0, tg_l, live_src, taps_t, alpha, w_reg, z0s, mesh, K,
                         momentum, thresh)
    it, mnorm = sharding._run_chunks(loop, S, max_iter, thresh, stall_window, stall_rel)
    if fused and mesh is not None:
        mesh.halo_bytes += loop.halo_bytes
        mesh.loop_halo_bytes += loop.halo_bytes
        mesh.loop_iterations += loop.iterations
    state = loop.state()
    return [st[0] for st in state], [st[1] for st in state], it, mnorm


def _pyramid_warmstart_local(psi_l, tg_l, tn_l, taps, alpha, w_reg, thresh, z0s, mesh, K,
                             levels, coarse_its, momentum):
    """The coarse-to-fine warm start on the slabs (``_pyramid_warmstart_local``):
    each slab's volumes and displacement mean-pooled per slab, every coarse
    level solved on kernel A's slab form at the full window K (no stall
    stop) to ``thresh * 0.5^L`` or coarse_its iterations, its displacement
    upsampled per slab (edge-extended at the slab seams) with its values
    doubled. Returns (psi_l warm-started at full resolution, int32[S]
    coarse iterations)."""
    down = sharding._downsample2_local
    pyr = [(tg_l, tn_l)]
    for _ in range(levels - 1):
        a, b = pyr[-1]
        pyr.append(([down(x) for x in a], [down(x) for x in b]))
    ident0 = [_ident(p.shape[-3:], z0, p.device) for p, z0 in zip(psi_l, z0s)]
    disp = [down(p - i) for p, i in zip(psi_l, ident0)]
    for _ in range(levels - 2):
        disp = [down(d) for d in disp]
    disp = [d * float(np.float32(1.0 / 2 ** (levels - 1))) for d in disp]
    total = np.zeros(psi_l[0].shape[0], np.int32)
    for lev in range(levels - 1, 0, -1):
        tg_c, tn_c = pyr[lev]
        nl_c = tg_c[0].shape[-3]
        if nl_c < H:
            raise ValueError(f"coarsest z-slab {nl_c} smaller than the halo radius {H}; "
                             "use fewer pyramid levels or z-shards")
        z0c = [j * nl_c for j in range(len(tg_c))]
        ident_c = [_ident(t.shape[-3:], z0, t.device) for t, z0 in zip(tg_c, z0c)]
        thresh_c = np.float32(thresh) * np.float32(0.5 ** lev)
        psi_c, _, it_c, _ = _gd_loop_local(
            [i + d for i, d in zip(ident_c, disp)], tg_c, tn_c, _halo_exchange_z(tn_c, K, mesh),
            taps, alpha, w_reg, coarse_its, thresh_c, z0c, mesh, K, fused=True,
            momentum=momentum)
        total = total + it_c
        up = tuple(pyr[lev - 1][0][0].shape[-3:])
        disp = [_per_scene(lambda d: sharding._upsample2_disp_local(d, up), p - i)
                for p, i in zip(psi_c, ident_c)]
    return [i + d for i, d in zip(ident0, disp)], total


def _solve_local(psi_l, tg_l, tn_l, taps, alpha, w_reg, max_iter, thresh, mesh, o):
    """The solve of ``local_solve`` / ``per_scene`` up to the tails, on the
    slabs of S scenes: the live warp source, the pyramid warm start, the
    fine loop (compositive with fine_window). Returns (psi_l, tnp_l, iters
    int32[S] with the coarse levels', coarse int32[S], mnorm float32[S])."""
    Zl = psi_l[0].shape[-3]
    z0s = [j * Zl for j in range(len(psi_l))]
    K = o["warp_window"]
    tn_src = _all_gather(tn_l, mesh) if K is None else _halo_exchange_z(tn_l, K, mesh)
    coarse = np.zeros(psi_l[0].shape[0], np.int32)
    if o["pyramid_levels"] > 1 and K is not None:
        c_its = o["coarse_max_iter"] if o["coarse_max_iter"] is not None else max_iter
        psi_l, coarse = _pyramid_warmstart_local(psi_l, tg_l, tn_l, taps, alpha, w_reg, thresh,
                                                 z0s, mesh, K, o["pyramid_levels"], int(c_its),
                                                 o["momentum"])
    fine_taps = o["taps_static"] if o["fused"] else taps
    loop = dict(fused=o["fused"], momentum=o["momentum"], stall_window=o["stall_window"],
                stall_rel=o["stall_rel"])
    Kf = o["fine_window"]
    if Kf is not None:
        # compositive fine level: T0 = live o psi0 once in the window K, the
        # increment loop from the identity at Kf halos, psi = psi0 o g
        ident = [_ident(p.shape[-3:], z0, p.device).expand_as(p).contiguous()
                 for p, z0 in zip(psi_l, z0s)]
        t0_l = [_per_scene(lambda v, p, z0=z0: _sample_window_local(v, p, z0, K), src, p)
                for src, p, z0 in zip(tn_src, psi_l, z0s)]
        g_l, tnp_l, iters, mnorm = _gd_loop_local(
            ident, tg_l, t0_l, _halo_exchange_z(t0_l, Kf, mesh), fine_taps, alpha, w_reg,
            max_iter, thresh, z0s, mesh, Kf, **loop)
        psi0_e = _halo_exchange_z(psi_l, Kf, mesh)
        psi_l = [_per_scene(lambda v, g, z0=z0: _sample_window_local(v, g, z0, Kf), e, g)
                 for e, g, z0 in zip(psi0_e, g_l, z0s)]
    else:
        psi_l, tnp_l, iters, mnorm = _gd_loop_local(psi_l, tg_l, tn_l, tn_src, fine_taps, alpha,
                                                    w_reg, max_iter, thresh, z0s, mesh, K,
                                                    **loop)
    return psi_l, tnp_l, iters + coarse, coarse, mnorm


def _inverse_local(psi_l, inv0_l, iters: int, K, mesh):
    """The inverse fixed point q <- id - disp(psi)(q) on the slabs, from
    inv0_l (None: the identity): with K None from the gathered displacement
    (the exact sampler), else from its K-halo exchange (the window)."""
    Zl = psi_l[0].shape[-3]
    z0s = [j * Zl for j in range(len(psi_l))]
    ident = [_ident(p.shape[-3:], z0, p.device) for p, z0 in zip(psi_l, z0s)]
    inv = [i.expand_as(p).contiguous() if q is None else q
           for i, p, q in zip(ident, psi_l, inv0_l)]
    if K is None:
        psi_full = _all_gather(psi_l, mesh)
        disp = [p - fields.identity_field(p.shape[-3:], device=p.device) for p in psi_full]
        for _ in range(int(iters)):
            inv = [_per_scene(lambda d, q, i=i: i - fields.sample_field_trilinear(d, q), dj, qj)
                   for dj, qj, i in zip(disp, inv, ident)]
    else:
        disp = _halo_exchange_z([p - i for p, i in zip(psi_l, ident)], K, mesh)
        for _ in range(int(iters)):
            inv = [_per_scene(lambda d, q, i=i, z0=z0: i - _sample_window_local(d, q, z0, K),
                              dj, qj) for dj, qj, i, z0 in zip(disp, inv, ident, z0s)]
    return inv


def _warp_local(vol_l, at_l, K, mesh, floor: bool):
    """Each slab's scenes of the volume sampled at at_l (global coordinates):
    from the gathered volume (K None) or its K-halo exchange."""
    src = _all_gather(vol_l, mesh) if K is None else _halo_exchange_z(vol_l, K, mesh)
    Zl = vol_l[0].shape[-3]
    if K is None:
        fn = fields.sample_nearest_floor if floor else fields.sample_trilinear
        return [_per_scene(fn, v, a) for v, a in zip(src, at_l)]
    return [_per_scene(lambda v, a, z0=z0: _sample_window_local(v, a, z0, K, floor), s, a)
            for s, a, z0 in zip(src, at_l, (j * Zl for j in range(len(vol_l))))]


# ---------------------------------------------------------------------------
# the sharded solve
# ---------------------------------------------------------------------------


def _check_opts(fused, warp_window, taps_static, fine_window) -> None:
    if fused and (warp_window is None or taps_static is None):
        raise ValueError("fused needs warp_window and taps_static")
    if fine_window is not None and warp_window is None:
        raise ValueError("fine_window requires warp_window")


def _slab_depth(Z: int, n_z: int) -> int:
    if Z % n_z:
        raise ValueError(f"a {Z}-deep grid does not split into {n_z} z-slabs")
    return Z // n_z


def _split(a: torch.Tensor, devs) -> list:
    """The z-slabs of a (axis -3) on their devices."""
    Zl = _slab_depth(a.shape[-3], len(devs))
    return [a[..., j * Zl:(j + 1) * Zl, :, :].to(d).contiguous() for j, d in enumerate(devs)]


def _join(xs, dev) -> torch.Tensor:
    return torch.cat([_to(x, dev) for x in xs], dim=-3)


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()


def make_sharded_estimate_psi(mesh: Mesh, inverse_iters: int = 48, warp_window=None,
                              fused: bool = False, taps_static=None, momentum=None,
                              warm_inverse: bool = False, pyramid_levels: int = 1,
                              coarse_max_iter=None, fine_window=None, stall_window: int = 0,
                              stall_rel: float = 1e-3, fold_xmats: bool = False):
    """The sharded solve over the z-slabs of the mesh's first scene row
    (``sobfu_tpu.parallel.make_sharded_estimate_psi``).

    Returns fn(psi, tsdf_global, weight_global, tsdf_n, weight_n, taps,
    alpha, w_reg, max_iter, thresh[, psi_inv0]) -> (psi, psi_inv, tnp, wnp,
    tgi, wgi, iters, max_norm): full-size tensors in (on any device) and
    out (on the mesh's first device), iters and max_norm 0-dim tensors on
    the host. Options as in JAX: fused (each fine iteration a launch of
    kernel A's slab form per slab; needs warp_window and taps_static),
    momentum, warm_inverse (fn takes psi_inv0), pyramid_levels /
    coarse_max_iter (with warp_window), fine_window (the compositive fine
    level; needs warp_window), stall_window / stall_rel. warp_window None is
    the exact mode: the live volume, psi, tg, wg and wn gathered whole.
    fold_xmats picks a TPU layout and is accepted and ignored.
    """
    del fold_xmats  # a TPU layout choice: nothing to select here
    _check_opts(fused, warp_window, taps_static, fine_window)
    opts = dict(warp_window=warp_window, fused=bool(fused),
                taps_static=None if taps_static is None else np.asarray(taps_static, np.float32),
                momentum=momentum, pyramid_levels=int(pyramid_levels),
                coarse_max_iter=coarse_max_iter, fine_window=fine_window,
                stall_window=int(stall_window), stall_rel=float(stall_rel))
    K = warp_window

    def fn(psi, tsdf_global, weight_global, tsdf_n, weight_n, taps, alpha, w_reg, max_iter,
           thresh, psi_inv0=None):
        if (psi_inv0 is not None) != bool(warm_inverse):
            raise TypeError("psi_inv0 is passed exactly when the solve has warm_inverse")
        devs = mesh.devices[0]
        lead = devs[0]
        psi_l, tg_l, wg_l, tn_l, wn_l = (_split(_f32(a, lead)[None], devs) for a in (
            psi, tsdf_global, weight_global, tsdf_n, weight_n))
        inv0_l = ([None] * len(devs) if psi_inv0 is None
                  else _split(_f32(psi_inv0, lead)[None], devs))
        taps = np.asarray(sharding._host(taps), np.float32)
        psi_l, tnp_l, iters, _, mnorm = _solve_local(
            psi_l, tg_l, tn_l, taps, float(sharding._host(alpha)), float(sharding._host(w_reg)),
            int(sharding._host(max_iter)), np.float32(sharding._host(thresh)), mesh, opts)
        inv_l = _inverse_local(psi_l, inv0_l, inverse_iters, K, mesh)
        tgi_l = _warp_local(tg_l, inv_l, K, mesh, False)
        wgi_l = _warp_local(wg_l, inv_l, K, mesh, True)
        wnp_l = _warp_local(wn_l, psi_l, K, mesh, True)
        outs = [_join(xs, lead)[0] for xs in (psi_l, inv_l, tnp_l, wnp_l, tgi_l, wgi_l)]
        return tuple(outs) + (torch.as_tensor(iters[0]), torch.as_tensor(mnorm[0]))

    return fn


def estimate_psi_sharded(mesh: Mesh, psi, tsdf_global, weight_global, tsdf_n, weight_n, taps,
                         alpha, w_reg, max_iter, thresh, inverse_iters: int = 48):
    """Build and run the sharded solve (``estimate_psi_sharded``)."""
    return make_sharded_estimate_psi(mesh, inverse_iters)(
        psi, tsdf_global, weight_global, tsdf_n, weight_n, taps, alpha, w_reg, max_iter, thresh)


# ---------------------------------------------------------------------------
# the frame step over a ('scene', 'z') mesh
# ---------------------------------------------------------------------------


class ShardedFrameStep:
    """The step of ``make_frame_step(..., mesh=)``, with the signature and
    returns of :class:`sobfu_tpu_torch.parallel.sharding.FrameStep`: the S
    scenes split over the mesh's scene rows (S a multiple of them), each
    scene's volumes over the row's z-slabs. Per scene-shard: each slab
    integrates its own rows, the sharded solve runs with the shard's scenes
    batched on kernel A's slab form, the inverse and the weight warp run on
    the slabs, each slab fuses its rows. Outputs are joined on the mesh's
    first device; ``coarse_iters`` holds the last call's coarse iterations
    per scene."""

    def __init__(self, dims_zyx, mesh: Mesh, **opts):
        self.mesh = mesh
        self.dims = tuple(int(d) for d in dims_zyx)
        self.opts = opts
        self.coarse_iters = np.zeros(0, np.int32)

    def __call__(self, psi_b, tg_b, wg_b, dists_b, vol2cam_b, intr, voxel_sizes, trunc, eta,
                 max_weight, taps, alpha, w_reg, max_iter, thresh, psi_inv0_b=None):
        o = self.opts
        lead = self.mesh.devices[0][0]
        a = sharding._step_inputs(self.dims, lead, o["warm_inverse"], psi_b, tg_b, wg_b, dists_b,
                                  vol2cam_b, intr, voxel_sizes, trunc, eta, max_weight, taps,
                                  alpha, w_reg, max_iter, thresh, psi_inv0_b)
        S = a.psi.shape[0]
        rows = self.mesh.shape["scene"]
        if S % rows:
            raise ValueError(f"{S} scenes do not split over {rows} scene rows")
        Sr = S // rows
        K = o["warp_window"]
        outs, iters, coarse, mnorm = [], [], [], []
        for r, devs in enumerate(self.mesh.devices):
            sc = slice(r * Sr, (r + 1) * Sr)
            psi_l, tg_l, wg_l = (_split(x[sc], devs) for x in (a.psi, a.tg, a.wg))
            inv0_l = [None] * len(devs) if a.psi_inv0 is None else _split(a.psi_inv0[sc], devs)
            Zl = tg_l[0].shape[-3]
            tn_l, wn_l = [], []
            for j, dev in enumerate(devs):
                zero = torch.zeros((Zl,) + self.dims[1:], dtype=torch.float32, device=dev)
                live = [tsdf.integrate_dists(zero, zero, d.to(dev), m, a.intr, a.vsz, a.trunc,
                                             a.eta, axis_aligned=o["axis_aligned"],
                                             z_offset=j * Zl)
                        for d, m in zip(a.dists[sc], a.v2c[sc])]
                tn_l.append(torch.stack([t for t, _ in live]))
                wn_l.append(torch.stack([w for _, w in live]))
            psi_l, tnp_l, it, co, mn = _solve_local(psi_l, tg_l, tn_l, a.taps, a.alpha, a.w_reg,
                                                    a.max_iter, a.thresh, self.mesh, o)
            inv_l = _inverse_local(psi_l, inv0_l, o["inverse_iters"], K, self.mesh)
            wnp_l = _warp_local(wn_l, psi_l, K, self.mesh, True)
            fused = [tsdf.fuse_volumes(*v, a.max_weight)
                     for v in zip(tg_l, wg_l, tnp_l, wnp_l)]
            outs.append([_join(xs, lead) for xs in (psi_l, inv_l, [f[0] for f in fused],
                                                    [f[1] for f in fused])])
            iters.append(it)
            coarse.append(co)
            mnorm.append(mn)
        self.coarse_iters = np.concatenate(coarse)
        psi, psi_inv, tg, wg = (torch.cat(xs) for xs in zip(*outs))
        return (psi, psi_inv, tg, wg, torch.as_tensor(np.concatenate(iters)),
                torch.as_tensor(np.concatenate(mnorm)))
