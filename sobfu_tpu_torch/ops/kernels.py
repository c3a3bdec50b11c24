"""The CUDA kernels of the frame loop and their plain torch versions.

==================  ==========================================  =============
wrapper             replaces (sobfu_tpu/ops/pallas_kernels.py)  source
==================  ==========================================  =============
gd_iteration (A)    fused_gd_iteration_pp :2443 (+ the db /     csrc/gd_iteration.cu
                    fold / stacked / step layouts)
gd_iteration_scenes fused_gd_iteration_db_padded :1075 (the     csrc/gd_iteration.cu
(A over scenes)     scene-batched frame step's kernel)
gd_iteration_slab   fused_gd_iteration_db_padded :1075 and      csrc/gd_iteration.cu
(A's slab form)     fused_gd_iteration_fold_padded :1704 with
                    z_base / z_global (the z-sharded solve)
warp (B)          window_warp_pallas :478,                    csrc/warp.cu
                    window_warp_pallas_mixed :508
inverse_fixed_point estimate_inverse_window_pallas_multi :3061  csrc/inverse.cu
(C)                 (+ estimate_inverse_window_pallas :1883)
warp_fuse (D)       window_warp_fuse_pallas :607                csrc/warp_fuse.cu
gd_multi (E)        fused_gd_multi_fold :2805                   csrc/gd_multi.cu
compose_weight (F)  compose_weight_pallas :3223                 csrc/compose_weight.cu
warp_field3 (B,     window_warp_field3_pallas :3309 (the K      csrc/warp.cu
C=3)                form; the exact form is XLA's
                    sobfu_tpu/fields.py sample_field_trilinear)
==================  ==========================================  =============

Each wrapper takes the JAX package's layouts and a window half-width ``K``
(None = the exact sampler, no displacement clamp). Dispatch is by device:
CPU tensors go to the plain torch version (``*_plain``, built from
:mod:`sobfu_tpu_torch.fields`); CUDA tensors launch the kernel on the
current stream or raise — there is no fallback. ``launch_counts`` counts
kernel launches per wrapper and is touched nowhere else.

The solve loops run kernel A through :class:`GdLoop`: up to ``GD_CHUNK``
iterations per call, each a launch that tests the stop rule on the device,
with one host read per call; its launches are counted as the iterations
that ran (the device's counter), under the same two names. The coarse
pyramid level runs kernel E through :class:`GdMultiLoop`: up to
``GD_MULTI_LAUNCHES`` chunks of 16 iterations per call, one launch each,
the stop rule tested on the device, one host read per call. The z-sharded
solve runs A's slab form through :class:`GdSlabLoop` over card groups (the
runs of consecutive slabs on one device): on one card one call of up to
``GD_CHUNK`` launches over all its slabs and one host read per chunk; on
several, a launch per card and iteration, the halo rows copied between
cards. Its launches are counted per group launch that ran, under
``gd_iteration_slab``; ``empty_launches`` counts the group launches
enqueued after the stop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from sobfu_tpu_torch import fields
from sobfu_tpu_torch.tsdf import fuse_volumes

launch_counts = {
    "gd_iteration": 0, "warp": 0, "inverse_fixed_point": 0, "warp_fuse": 0, "gd_multi": 0,
    "compose_weight": 0, "warp_field3": 0, "gd_iteration_scenes": 0, "gd_iteration_slab": 0,
}

# what each kernel replaces and where its source lives (chip_smoke.py reports it)
KERNELS = {
    "gd_iteration": (
        "sobfu_tpu_torch/csrc/gd_iteration.cu",
        "sobfu_tpu/ops/pallas_kernels.py:2443",
    ),
    "warp": ("sobfu_tpu_torch/csrc/warp.cu", "sobfu_tpu/ops/pallas_kernels.py:478"),
    "inverse_fixed_point": (
        "sobfu_tpu_torch/csrc/inverse.cu",
        "sobfu_tpu/ops/pallas_kernels.py:3061",
    ),
    "warp_fuse": (
        "sobfu_tpu_torch/csrc/warp_fuse.cu",
        "sobfu_tpu/ops/pallas_kernels.py:607",
    ),
    "gd_multi": (
        "sobfu_tpu_torch/csrc/gd_multi.cu",
        "sobfu_tpu/ops/pallas_kernels.py:2805",
    ),
    "compose_weight": (
        "sobfu_tpu_torch/csrc/compose_weight.cu",
        "sobfu_tpu/ops/pallas_kernels.py:3223",
    ),
    "warp_field3": ("sobfu_tpu_torch/csrc/warp.cu", "sobfu_tpu/ops/pallas_kernels.py:3309"),
    "gd_iteration_scenes": (
        "sobfu_tpu_torch/csrc/gd_iteration.cu",
        "sobfu_tpu/ops/pallas_kernels.py:1075",
    ),
    "gd_iteration_slab": (
        "sobfu_tpu_torch/csrc/gd_iteration.cu",
        "sobfu_tpu/ops/pallas_kernels.py:1075",
    ),
}

# voxels per tile of the kernels' reductions (csrc/sampling.cuh kBlock)
TILE = 256

# kernel B's launch shape by channel count (csrc/warp.cu launch_warpn):
# (voxels a thread, tile width, tile depth in y); a block takes a tile of
# width x depth x TILE / (width depth) voxels stacked that many voxels a
# thread deep in z, or with width 0 the volume's rows (voxel b * TILE * per
# + t + j * TILE). C > 3 runs one voxel a thread in rows.
WARP_LAUNCH = {1: (2, 32, 4), 2: (1, 0, 0), 3: (1, 32, 4)}


# the solve loops: host reads of the device's stop state (one per call of
# kernel A's GdLoop and of kernel E's GdMultiLoop), and the launches
# enqueued after the loop (or every scene) had stopped
host_reads = {"gd_iteration": 0, "gd_iteration_scenes": 0, "gd_multi": 0,
              "gd_iteration_slab": 0}
empty_launches = {"gd_iteration": 0, "gd_iteration_scenes": 0, "gd_multi": 0,
                  "gd_iteration_slab": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, host_reads, empty_launches):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------


def _on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> int:
    """Validate a kernel operand; returns its device pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def _K(K: Optional[int]) -> int:
    if K is None:
        return -1
    if int(K) < 0:
        raise ValueError(f"window half-width K must be >= 0 or None, got {K}")
    return int(K)


def _launch(kernel: str, fn_name: str, device, *args) -> None:
    from sobfu_tpu_torch.ops._build import library

    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    launch_counts[kernel] += 1


# ---------------------------------------------------------------------------
# B: warp
# ---------------------------------------------------------------------------


def warp_plain(vol, psi, K: Optional[int], floor: Sequence[bool]):
    """vol f32[C,Z,Y,X] sampled at psi; channel c uses the floor-corner rule
    where floor[c], trilinear otherwise; K None = exact sampler."""
    outs = []
    for c in range(vol.shape[0]):
        if K is None:
            f = fields.sample_nearest_floor if floor[c] else fields.sample_trilinear
            outs.append(f(vol[c], psi))
        else:
            f = (
                fields.sample_nearest_floor_window
                if floor[c]
                else fields.sample_trilinear_window
            )
            outs.append(f(vol[c], psi, K))
    return torch.stack(outs, dim=0)


def _launch_warp(kernel: str, vol, psi, K: Optional[int], floor: Sequence[bool]):
    C = vol.shape[0]
    if C > 32:
        raise ValueError("warp takes at most 32 channels")
    Z, Y, X = vol.shape[1:]
    if Z * Y * X >= 2 ** 31:
        raise ValueError(f"warp takes grids under 2^31 voxels, got {Z * Y * X}")
    dev = vol.device
    out = torch.empty_like(vol)
    mask = sum(1 << c for c in range(C) if floor[c])
    _launch(
        kernel, "sobfu_warp", dev,
        _check("vol", vol, (C, Z, Y, X), dev), C,
        _check("psi", psi, (3, Z, Y, X), dev),
        _check("out", out, (C, Z, Y, X), dev),
        Z, Y, X, _K(K), mask,
    )
    return out


def warp(vol, psi, K: Optional[int], floor: Sequence[bool]):
    """Kernel B: warp the C channels of vol f32[C,Z,Y,X] at psi."""
    C = vol.shape[0]
    if len(floor) != C:
        raise ValueError(f"floor has {len(floor)} entries for {C} channels")
    if _on_cpu(vol):
        return warp_plain(vol, psi, K, floor)
    return _launch_warp("warp", vol, psi, K, floor)


def warp_field3_plain(field, pos, K: Optional[int]):
    if K is None:
        return fields.sample_field_trilinear(field, pos)
    return fields.sample_trilinear_window(field, pos, K)


def warp_field3(field, pos, K: Optional[int]):
    """Kernel B with C=3 trilinear channels: the 3-channel field f32[3,Z,Y,X]
    sampled at pos, the taps and corner offsets computed once for all three
    (the compositive composition psi0 o (id + delta), the incremental
    inverse's sample). K None = the exact sampler. Bit for bit with its plain
    version and with three one-channel :func:`warp` launches; one launch,
    counted under its own name, apart from :func:`warp`."""
    if field.shape[0] != 3:
        raise ValueError(f"warp_field3 samples a 3-channel field, got {field.shape[0]}")
    if _on_cpu(field):
        return warp_field3_plain(field, pos, K)
    return _launch_warp("warp_field3", field, pos, K, (False,) * 3)


# ---------------------------------------------------------------------------
# F: composition + weight floor sample
# ---------------------------------------------------------------------------


def compose_weight_plain(field, pos, weight, Kf: int, Kw: int):
    psi_new = fields.sample_trilinear_window(field, pos, Kf)
    return psi_new, fields.sample_nearest_floor_window(weight, psi_new, Kw)


def compose_weight(field, pos, weight, Kf: int, Kw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel F: psi_new = field o pos in the window Kf (field f32[3,Z,Y,X]
    is psi0, pos the absolute g = id + delta) and weight f32[Z,Y,X]
    floor-sampled at psi_new in the window Kw; returns (psi_new, weight at
    psi_new), both equal bit for bit to the plain version."""
    if Kf is None or Kw is None:
        raise ValueError("compose_weight samples in windows: Kf and Kw must be set")
    if _on_cpu(field):
        return compose_weight_plain(field, pos, weight, Kf, Kw)
    Z, Y, X = field.shape[1:]
    dev = field.device
    out = torch.empty_like(field)
    wout = torch.empty_like(weight)
    _launch(
        "compose_weight", "sobfu_compose_weight", dev,
        _check("field", field, (3, Z, Y, X), dev),
        _check("pos", pos, (3, Z, Y, X), dev),
        _check("weight", weight, (Z, Y, X), dev),
        _check("out", out, (3, Z, Y, X), dev),
        _check("weight_out", wout, (Z, Y, X), dev),
        Z, Y, X, _K(Kf), _K(Kw),
    )
    return out, wout


# ---------------------------------------------------------------------------
# C: inverse fixed point
# ---------------------------------------------------------------------------


def inverse_fixed_point_plain(psi, iters: int, K: Optional[int], init=None):
    if K is None:
        return fields.estimate_inverse(psi, iters, init=init)
    return fields.estimate_inverse_window(psi, iters, K, init=init)


# voxels a thread of kernel C takes, a block width apart (csrc/inverse.cu
# kInversePer): voxel i of block b, thread t is b * TILE * INVERSE_PER + t
# + j * TILE for j < INVERSE_PER
INVERSE_PER = 2


def inverse_fixed_point(psi, iters: int, K: Optional[int], init=None):
    """Kernel C: ``iters`` steps of q <- v - disp(psi)(q) from ``init``
    (None = identity) in one launch."""
    if _on_cpu(psi):
        return inverse_fixed_point_plain(psi, iters, K, init)
    Z, Y, X = psi.shape[1:]
    if Z * Y * X >= 2 ** 31:
        raise ValueError(f"inverse_fixed_point takes grids under 2^31 voxels, got {Z * Y * X}")
    if int(iters) < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    dev = psi.device
    out = torch.empty_like(psi)
    _launch(
        "inverse_fixed_point", "sobfu_inverse_fixed_point", dev,
        _check("psi", psi, (3, Z, Y, X), dev),
        None if init is None else _check("init", init, (3, Z, Y, X), dev),
        _check("out", out, (3, Z, Y, X), dev),
        Z, Y, X, _K(K), int(iters),
    )
    return out


# ---------------------------------------------------------------------------
# D: warp + fuse
# ---------------------------------------------------------------------------


def warp_fuse_plain(tsdf_g, weight_g, tsdf_n_psi, weight_n, psi, max_weight, K):
    wnp = warp_plain(weight_n[None], psi, K, (True,))[0]
    return fuse_volumes(tsdf_g, weight_g, tsdf_n_psi, wnp, max_weight)


def warp_fuse(
    tsdf_g, weight_g, tsdf_n_psi, weight_n, psi, max_weight: float, K: Optional[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: floor-warp weight_n at psi and fuse (tsdf_n_psi, warped
    weight) into (tsdf_g, weight_g); returns the new canonical pair."""
    if _on_cpu(tsdf_g):
        return warp_fuse_plain(tsdf_g, weight_g, tsdf_n_psi, weight_n, psi, max_weight, K)
    dims = tuple(tsdf_g.shape)
    Z, Y, X = dims
    dev = tsdf_g.device
    tg_out = torch.empty_like(tsdf_g)
    wg_out = torch.empty_like(weight_g)
    _launch(
        "warp_fuse", "sobfu_warp_fuse", dev,
        _check("tsdf_g", tsdf_g, dims, dev),
        _check("weight_g", weight_g, dims, dev),
        _check("tsdf_n_psi", tsdf_n_psi, dims, dev),
        _check("weight_n", weight_n, dims, dev),
        _check("psi", psi, (3,) + dims, dev),
        float(max_weight),
        _check("tsdf_out", tg_out, dims, dev),
        _check("weight_out", wg_out, dims, dev),
        Z, Y, X, _K(K),
    )
    return tg_out, wg_out


# ---------------------------------------------------------------------------
# A: gradient-descent iteration
# ---------------------------------------------------------------------------


def _n_tiles(dims) -> int:
    Z, Y, X = dims
    return (Z * Y * X + TILE - 1) // TILE


def gd_iteration_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K,
                       with_energy: bool = False):
    """solver.estimate_psi's XLA step: returns (psi', tnp', vel', max |upd|^2)
    with vel' None when momentum is None, and with_energy appends
    solver.data_energy(tg, tnp')."""
    from sobfu_tpu_torch.solver import data_energy, sobolev_smooth

    grad = fields.tsdf_gradient(tnp)
    lap = fields.neg_laplacian(psi)
    dU = (tnp - tg)[None] * grad + w_reg * lap
    dU_S = sobolev_smooth(dU, taps)
    if momentum is not None:
        vel_new = momentum * vel + dU_S
        update = alpha * vel_new
    else:
        vel_new = None
        update = alpha * dU_S
    psi_new = psi - update
    tnp_new = warp_plain(live[None], psi_new, K, (False,))[0]
    max_sq = torch.max(torch.sum(update * update, dim=0))
    if with_energy:
        return psi_new, tnp_new, vel_new, max_sq, data_energy(tg, tnp_new)
    return psi_new, tnp_new, vel_new, max_sq


# A block of kernel A owns TILE_X columns by 8 rows (csrc/gd_iteration.cu
# kTileX, kTileY) and marches LZ planes; the card's shared memory per block
TILE_X = 32
SHARED_LIMIT = 232448
# iterations enqueued per host read of the chunked loops (a chunk also ends
# at each stall check and at max_iter)
GD_CHUNK = 16


def gd_tile_plan(dims, n_taps: int, n_sm: int = 132, min_lz: int = 4) -> dict:
    """Kernel A's tile plan for a grid (Z, Y, X): a block's (y, x) tile is
    TY x 32 = 8 x 32 voxels (csrc/gd_iteration.cu kTileY, kTileX: a voxel a
    thread per plane) and it marches a z segment of LZ planes, with a ring
    of n_taps + 1 dU planes (3 channels, the tile plus a halo of r = n_taps
    // 2 on its four sides) in shared memory. LZ, the one free choice, is
    the longest segment that still gives every SM four blocks, at least
    min_lz planes (a segment computes LZ + 2r planes of dU); the launch
    takes it. Returns TY, LZ, halo, the tile counts, blocks and
    shared_bytes."""
    Z, Y, X = (int(d) for d in dims)
    r = int(n_taps) // 2
    TY = 8
    tiles_y, tiles_x = -(-Y // TY), -(-X // TILE_X)
    want = max(1, 4 * n_sm // (tiles_y * tiles_x))  # segments for 4 blocks an SM
    LZ = max(min(min_lz, Z), -(-Z // want))
    segs = -(-Z // LZ)
    shared = 4 * 3 * (n_taps + 1) * (TY + 2 * r) * (TILE_X + 2 * r)
    if shared > SHARED_LIMIT:
        raise ValueError(f"kernel A's dU ring needs {shared} bytes of shared memory")
    return dict(TY=TY, LZ=LZ, halo=r, tiles_y=tiles_y, tiles_x=tiles_x, segs=segs,
                blocks=tiles_y * tiles_x * segs, shared_bytes=shared)


def _n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch_gd_chunk(bufs, tg, live, taps, alpha, w_reg, momentum, K, thresh, ctl, max_sq,
                     parts, e, n: int, plan: dict, copy_frozen: bool = False) -> None:
    """Enqueue n launches of kernel A (sobfu_gd_iterations) on the ping-pong
    buffers bufs = ((psi, tnp, vel), (psi, tnp, vel)) of S scenes; nothing
    is counted here. copy_frozen (n = 1): a frozen scene's state is copied
    to the other buffer."""
    from sobfu_tpu_torch.ops._build import library

    (psi0, tnp0, vel0), (psi1, tnp1, vel1) = bufs
    S, _, Z, Y, X = psi0.shape
    dev = psi0.device
    if not 1 <= S <= 65535:
        raise ValueError(f"kernel A takes 1..65535 scenes, got {S}")
    if Z * Y * X >= 2 ** 31:
        raise ValueError(f"kernel A takes grids under 2^31 voxels, got {Z * Y * X}")
    vols, flds = (S, Z, Y, X), (S, 3, Z, Y, X)
    s = _check_taps(taps, dev)
    has_vel = momentum is not None
    if tuple(ctl.shape) != (n + 1, S) or ctl.dtype != torch.int32 or not ctl.is_contiguous():
        raise ValueError(f"ctl: {ctl.dtype}{tuple(ctl.shape)}, expected int32 ({n + 1}, {S})")
    with torch.cuda.device(dev):
        rc = library().sobfu_gd_iterations(
            _check("psi", psi0, flds, dev), _check("psi", psi1, flds, dev),
            _check("tnp", tnp0, vols, dev), _check("tnp", tnp1, vols, dev),
            _check("vel", vel0, flds, dev) if has_vel else None,
            _check("vel", vel1, flds, dev) if has_vel else None,
            _check("tg", tg, vols, dev), _check("live", live, vols, dev),
            taps.data_ptr(), s,
            float(alpha), float(w_reg), float(momentum) if has_vel else 0.0, float(thresh),
            ctl.data_ptr(), _check("max_sq", max_sq, (n, S), dev),
            None if e is None else _check("e_partials", parts, (S, _n_tiles((Z, Y, X))), dev),
            None if e is None else _check("e_data", e, (S,), dev),
            n, S, Z, Y, X, _K(K), plan["LZ"], int(copy_frozen),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gd_iteration: CUDA launch failed with error {rc}")


def _launch_gd(kernel: str, lead: tuple, psi, tnp, vel, tg, live, taps, alpha, w_reg,
               momentum, K, active, with_energy: bool):
    """One iteration of A as a call of its own, counted under ``kernel``:
    lead () for one scene (psi f32[3,Z,Y,X]; the norm and energy 0-dim),
    (S,) for S scenes (psi f32[S,3,Z,Y,X]; the norms and energies f32[S]).
    active None = every scene runs; an inactive scene's state is passed
    through."""
    S = lead[0] if lead else 1
    Z, Y, X = psi.shape[-3:]
    dev = psi.device
    if active is not None:
        if active.device != dev or active.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"active: {active.dtype} on {active.device}, expected bool on {dev}")
        if tuple(active.shape) != (S,) or not active.is_contiguous():
            raise ValueError(f"active: shape {tuple(active.shape)}, expected ({S},) contiguous")
    if psi.dim() != len(lead) + 4:
        raise ValueError(f"psi: shape {tuple(psi.shape)}, expected {lead + (3, Z, Y, X)}")
    has_vel = momentum is not None

    def scenes(t):  # a scene axis on the unbatched operands (a view)
        return t if lead else t[None]

    f32 = dict(dtype=torch.float32, device=dev)
    psi_out, tnp_out = torch.empty_like(psi), torch.empty_like(tnp)
    vel_out = torch.empty_like(psi) if has_vel else None
    ctl = torch.zeros((2, S), dtype=torch.int32, device=dev)
    if active is not None:
        ctl[0] = active.to(torch.int32) - 1       # 0: runs; -1: frozen at 0 iterations
    max_sq = torch.empty((1, S), **f32)
    parts = torch.empty((S, _n_tiles((Z, Y, X))), **f32) if with_energy else None
    e = torch.empty((S,), **f32) if with_energy else None
    bufs = ((scenes(psi), scenes(tnp), scenes(vel) if has_vel else None),
            (scenes(psi_out), scenes(tnp_out), scenes(vel_out) if has_vel else None))
    _launch_gd_chunk(bufs, scenes(tg), scenes(live), taps, alpha, w_reg, momentum, K, 0.0, ctl,
                     max_sq, parts, e, 1, gd_tile_plan((Z, Y, X), taps.shape[0], _n_sm(dev)),
                     copy_frozen=True)
    launch_counts[kernel] += 1
    out = (psi_out, tnp_out, vel_out, max_sq.reshape(lead))
    return out + (e.reshape(lead),) if with_energy else out


def gd_iteration(
    psi, tnp, vel, tg, live, taps, alpha: float, w_reg: float,
    momentum: Optional[float], K: Optional[int], with_energy: bool = False,
):
    """Kernel A: one gradient-descent iteration in one launch (two more
    small ones with the energy; counted once): the launch of
    :func:`gd_iteration_scenes` with one scene and no scene axis. The solve
    loops run A through :class:`GdLoop`, many iterations per call.

    psi f32[3,Z,Y,X]; tnp, tg, live f32[Z,Y,X]; vel f32[3,Z,Y,X] when
    momentum is set, else ignored; taps f32[s] (s odd, <= 11). Returns
    (psi', tnp', vel' or None, max squared update norm as a 0-dim tensor);
    with_energy appends the data energy 0.5 * sum (tg - tnp')^2 (0-dim),
    reduced in a fixed order (the same bits on every run).
    """
    if _on_cpu(psi):
        return gd_iteration_plain(
            psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K, with_energy
        )
    return _launch_gd("gd_iteration", (), psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum,
                      K, None, with_energy)


def gd_iteration_scenes_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K,
                              active, with_energy: bool = False):
    """:func:`gd_iteration_plain` on each scene whose ``active`` entry is
    set; an inactive scene passes through with max_sq (and energy) 0."""
    outs = []
    for s, on in enumerate(active.tolist()):
        v = vel[s] if momentum is not None else None
        if on:
            outs.append(gd_iteration_plain(psi[s], tnp[s], v, tg[s], live[s], taps, alpha,
                                           w_reg, momentum, K, with_energy))
        else:
            zero = psi.new_zeros(())
            outs.append((psi[s], tnp[s], v, zero) + ((zero,) if with_energy else ()))
    cols = [torch.stack(col) if col[0] is not None else None for col in zip(*outs)]
    return tuple(cols)


def gd_iteration_scenes(
    psi, tnp, vel, tg, live, taps, alpha: float, w_reg: float,
    momentum: Optional[float], K: Optional[int], active, with_energy: bool = False,
):
    """Kernel A over a leading scene axis: one launch for all S scenes
    (counted once, apart from :func:`gd_iteration`).

    psi f32[S,3,Z,Y,X]; tnp, tg, live f32[S,Z,Y,X]; vel f32[S,3,Z,Y,X] when
    momentum is set, else ignored; active bool or uint8 [S] on the same
    device: a scene whose entry is 0 keeps psi, tnp and vel unchanged and
    reports max_sq 0, as a scene whose while_loop predicate is false does
    under jax.vmap. Returns (psi', tnp', vel' or None, max_sq f32[S]);
    with_energy appends e_data f32[S] (A's fixed-order energy per scene, 0
    for an inactive scene). Scene s equals :func:`gd_iteration` on scene s
    bit for bit.
    """
    if _on_cpu(psi):
        return gd_iteration_scenes_plain(
            psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K, active, with_energy
        )
    if active is None:
        raise TypeError("gd_iteration_scenes: active is a bool tensor of shape (S,)")
    return _launch_gd("gd_iteration_scenes", tuple(psi.shape[:1]), psi, tnp, vel, tg, live,
                      taps, alpha, w_reg, momentum, K, active, with_energy)


def gd_iterations_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K, thresh,
                        active, n: int, with_energy: bool = False):
    """Up to n chained :func:`gd_iteration_scenes_plain` steps with the
    device's stop rule: scene s runs step k iff ``active[s]`` and, for k >
    0, it ran step k - 1 with sqrt(max_sq) > thresh (in float32; a NaN norm
    stops). A stopped scene keeps its state. active is a bool array [S] on
    the host. Returns (psi, tnp, vel, done int32[S] — the steps each scene
    ran —, max_sq float32[n, S] with 0 where a scene did not run, and the
    data energy float32[S] after step n - 1 of the scenes that ran it, 0
    for the others; None without with_energy), the last three on the host."""
    import numpy as np

    S = psi.shape[0]
    on = np.asarray(active, bool).copy()
    done = np.zeros(S, np.int32)
    rows = np.zeros((n, S), np.float32)
    e = np.zeros(S, np.float32) if with_energy else None
    for k in range(n):
        if k:
            on &= np.sqrt(rows[k - 1]) > np.float32(thresh)
        if not on.any():
            break
        last = with_energy and k == n - 1
        out = gd_iteration_scenes_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum,
                                        K, torch.as_tensor(on), last)
        psi, tnp, vel = out[:3]
        rows[k] = out[3].cpu().numpy()
        done += on
        if last:
            e = out[4].cpu().numpy()
    return psi, tnp, vel, done, rows, e


def _chunk_start(count, active) -> torch.Tensor:
    """A chunk's ctl start row int32[S] (host): each scene's iterations so
    far, or -1 minus them for a scene that does not run."""
    import numpy as np

    return torch.from_numpy(np.where(active, count, -count - 1).astype(np.int32))


def _chunk_end(kernel: str, end, count, n: int, launches: int = 1):
    """done int32[S] of a chunk of n iterations from its ctl end row read
    back (the card's counters) and the host's count. Each iteration that ran
    counts as ``launches`` launches of ``kernel`` (launches are counted
    where they happen: on the card), the rest of the chunk as empty ones."""
    import numpy as np

    done = (np.where(end >= 0, end, -end - 1) - count).astype(np.int32)
    if end.shape != count.shape or (done < 0).any() or (done > n).any():
        raise RuntimeError(f"kernel A's iteration counter ({kernel}) is inconsistent: {end}")
    ran = int(done.max())
    launch_counts[kernel] += ran * launches
    empty_launches[kernel] += (n - ran) * launches
    return done


class GdLoop:
    """The state of one solve's gradient-descent loop on kernel A, advanced
    in chunks of iterations with one host read per chunk.

    psi f32[S,3,Z,Y,X], tnp, tg, live f32[S,Z,Y,X] (an unbatched solve
    passes S = 1 views); ``kernel`` names the count the iterations go under
    ("gd_iteration" or "gd_iteration_scenes"). On the card the state lives
    in a ping-pong pair of buffers allocated here, once per solve (psi and
    tnp are copied in); :meth:`run` enqueues n launches in one call
    (sobfu_gd_iterations), each of which tests the stop rule of
    :func:`gd_iterations_plain` on the card, and reads the outcome back
    once. On the CPU it runs :func:`gd_iterations_plain`. energy: the loop
    will ask for the data energy (scratch for its partials).
    """

    def __init__(self, kernel: str, psi, tnp, tg, live, taps, alpha, w_reg, momentum, K,
                 thresh, energy: bool = False):
        import numpy as np

        self.kernel = kernel
        self.args = (tg, live, taps, alpha, w_reg, momentum, K, float(thresh))
        S = psi.shape[0]
        self.count = np.zeros(S, np.int64)  # iterations each scene has done
        self.cpu = _on_cpu(psi)
        vel = torch.zeros_like(psi) if momentum is not None else None
        if self.cpu:
            self.cur = (psi, tnp, vel)
            return
        dev = psi.device
        dims = tuple(psi.shape[-3:])
        other = (torch.empty_like(psi), torch.empty_like(tnp),
                 torch.empty_like(psi) if vel is not None else None)
        self.bufs = ((psi.clone(), tnp.clone(), vel), other)
        self.plan = gd_tile_plan(dims, taps.shape[0], _n_sm(dev))
        # one device buffer for everything the host reads per chunk: ctl rows
        # 0..GD_CHUNK (int32), then the norm rows and the energy (float32 bits)
        self.out = torch.zeros((2 * GD_CHUNK + 2, S), dtype=torch.int32, device=dev)
        self.parts = (torch.empty((S, _n_tiles(dims)), dtype=torch.float32, device=dev)
                      if energy else None)

    def run(self, n: int, active, with_energy: bool = False):
        """Up to n (<= GD_CHUNK) iterations from the current state; active
        bool[S] (host) names the scenes that run. Returns (done int32[S],
        max_sq float32[n, S], energy float32[S] or None) as
        :func:`gd_iterations_plain` does, on the host."""
        import numpy as np

        if not 1 <= n <= GD_CHUNK:
            raise ValueError(f"a chunk is 1..{GD_CHUNK} iterations, got {n}")
        active = np.asarray(active, bool)
        tg, live, taps, alpha, w_reg, momentum, K, thresh = self.args
        if self.cpu:
            *self.cur, done, rows, e = gd_iterations_plain(
                *self.cur, tg, live, taps, alpha, w_reg, momentum, K, thresh, active, n,
                with_energy)
        else:
            if with_energy and self.parts is None:
                raise ValueError("this GdLoop was made without energy")
            ctl, rest = self.out[:n + 1], self.out[GD_CHUNK + 1:].view(torch.float32)
            max_sq, e_dev = rest[:n], rest[GD_CHUNK]
            ctl[0].copy_(_chunk_start(self.count, active))
            _launch_gd_chunk(self.bufs, tg, live, taps, alpha, w_reg, momentum, K, thresh, ctl,
                             max_sq, self.parts, e_dev if with_energy else None, n, self.plan)
            host = self.out.cpu().numpy()
            done = _chunk_end(self.kernel, host[n], self.count, n)
            rest = host[GD_CHUNK + 1:].view(np.float32)
            rows = rest[:n].copy()
            e = rest[GD_CHUNK].copy() if with_energy else None
        self.count += done
        host_reads[self.kernel] += 1
        return done, rows, e

    def state(self):
        """(psi, tnp, vel or None) after the iterations run so far, with the
        scene axis; on the card views of the loop's buffers where every
        scene's state lies in the same one."""
        if self.cpu:
            return tuple(self.cur)
        par = self.count & 1
        if (par == par[0]).all():
            return self.bufs[int(par[0])]
        return tuple(
            None if a is None else torch.stack([(b if p else a)[s] for s, p in enumerate(par)])
            for a, b in zip(*self.bufs))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_taps(taps, dev) -> int:
    s = taps.shape[0]
    if s % 2 == 0 or s > 11:
        raise ValueError(f"taps must be odd and at most 11 long, got {s}")
    _check("taps", taps, (s,), dev)
    return s


# ---------------------------------------------------------------------------
# E: n gradient-descent iterations in one launch
# ---------------------------------------------------------------------------


class MultiOut(NamedTuple):
    """Kernel E's outputs; the per-iteration rows are f32[n_inner]."""

    psi: torch.Tensor
    tnp: torch.Tensor
    vel: Optional[torch.Tensor]
    mx_sq: torch.Tensor            # max squared update norm of each iteration
    e_data: Optional[torch.Tensor]  # 0.5 sum (tg - tnp')^2 after each (with_energy)
    e_pre: Optional[torch.Tensor]   # data energy before each (with_verbose)
    e_reg: Optional[torch.Tensor]   # regulariser energy before each (with_verbose)


def gd_multi_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K,
                   n_inner: int, with_energy: bool = False,
                   with_verbose: bool = False) -> MultiOut:
    """n_inner chained :func:`gd_iteration_plain` steps, with the row outputs
    of fused_gd_multi_fold (every mx_sq row is filled)."""
    from sobfu_tpu_torch.solver import data_energy, reg_energy_sobolev

    mx, e_data, e_pre, e_reg = [], [], [], []
    for _ in range(int(n_inner)):
        if with_verbose:
            e_pre.append(data_energy(tg, tnp))
            e_reg.append(reg_energy_sobolev(psi))
        out = gd_iteration_plain(
            psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K, with_energy
        )
        psi, tnp, vel = out[:3]
        mx.append(out[3])
        e_data.append(out[4] if with_energy else None)
    stack = torch.stack
    return MultiOut(
        psi, tnp, vel, stack(mx),
        stack(e_data) if with_energy else None,
        stack(e_pre) if with_verbose else None,
        stack(e_reg) if with_verbose else None,
    )


def _launch_gd_multi(ins, bufs, tg, live, taps, alpha, w_reg, momentum, K, plan, n_inner: int,
                     n_launch: int, max_sq, ctl=None, thresh=0.0, max_iter=0, stall_window=0,
                     stall_rel=0.0, e_data=None, energy_every=False, e_pre=None, e_reg=None,
                     parts=None) -> None:
    """Enqueue n_launch launches of kernel E (sobfu_gd_multi) on the
    ping-pong buffers bufs = ((psi, tnp, vel), (psi, tnp, vel)); ins, if
    set, is the (psi, tnp, vel) that iteration 0 reads (with ctl None: one
    launch from count 0, no stop test). Nothing is counted here."""
    from sobfu_tpu_torch.ops._build import library

    (psi0, tnp0, vel0), (psi1, tnp1, vel1) = bufs
    Z, Y, X = psi0.shape[1:]
    dev = psi0.device
    if Z * Y * X >= 2 ** 31:
        raise ValueError(f"kernel E takes grids under 2^31 voxels, got {Z * Y * X}")
    vol, fld = (Z, Y, X), (3, Z, Y, X)
    s = _check_taps(taps, dev)
    has_vel = momentum is not None
    rows = (n_launch, n_inner)
    if ctl is not None and (tuple(ctl.shape) != (n_launch + 1, 4) or ctl.dtype != torch.int32
                            or not ctl.is_contiguous()):
        raise ValueError(f"ctl: {ctl.dtype}{tuple(ctl.shape)}, expected int32 ({n_launch + 1}, 4)")
    psi_in, tnp_in, vel_in = ins if ins is not None else (None, None, None)
    with torch.cuda.device(dev):
        rc = library().sobfu_gd_multi(
            None if ins is None else _check("psi", psi_in, fld, dev),
            None if ins is None else _check("tnp", tnp_in, vol, dev),
            _check("vel", vel_in, fld, dev) if ins is not None and has_vel else None,
            _check("psi", psi0, fld, dev), _check("psi", psi1, fld, dev),
            _check("tnp", tnp0, vol, dev), _check("tnp", tnp1, vol, dev),
            _check("vel", vel0, fld, dev) if has_vel else None,
            _check("vel", vel1, fld, dev) if has_vel else None,
            _check("tg", tg, vol, dev), _check("live", live, vol, dev), taps.data_ptr(), s,
            float(alpha), float(w_reg), float(momentum) if has_vel else 0.0, float(thresh),
            int(max_iter), int(stall_window), float(stall_rel),
            None if ctl is None else ctl.data_ptr(), _check("max_sq", max_sq, rows, dev),
            None if e_data is None else _check("e_data", e_data, rows, dev), int(energy_every),
            _ptr(e_pre), _ptr(e_reg),
            None if parts is None else _check("parts", parts, (4 * _n_tiles(vol),), dev),
            n_inner, n_launch, Z, Y, X, _K(K), plan["LZ"],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gd_multi: CUDA launch failed with error {rc}")


def gd_multi(
    psi, tnp, vel, tg, live, taps, alpha: float, w_reg: float,
    momentum: Optional[float], K: Optional[int], n_inner: int,
    with_energy: bool = False, with_verbose: bool = False,
) -> MultiOut:
    """Kernel E: n_inner iterations of kernel A in one cooperative launch.

    Operands as :func:`gd_iteration`. Equal bit for bit to n_inner chained
    gd_iteration calls: state, velocity, every mx_sq row and every e_data
    row. with_verbose adds the pre-update data and regulariser energies of
    each iteration (the rows record_energy keeps). The solve loops run E
    through :class:`GdMultiLoop`.
    """
    n_inner = int(n_inner)
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    if _on_cpu(psi):
        return gd_multi_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K,
                              n_inner, with_energy, with_verbose)
    dims = tuple(psi.shape[1:])
    dev = psi.device
    has_vel = momentum is not None
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty_like(psi), torch.empty_like(tnp), torch.empty_like(psi) if has_vel else None)
    tmp = (torch.empty_like(psi), torch.empty_like(tnp), torch.empty_like(psi) if has_vel else None)
    # iteration c writes buffer (c + 1) & 1: the last one writes out
    bufs = (out, tmp) if n_inner % 2 == 0 else (tmp, out)
    mx_sq = torch.empty((1, n_inner), **f32)
    e_data = torch.empty((1, n_inner), **f32) if with_energy else None
    e_pre = torch.empty(n_inner, **f32) if with_verbose else None
    e_reg = torch.empty(n_inner, **f32) if with_verbose else None
    parts = torch.empty(4 * _n_tiles(dims), **f32) if with_energy or with_verbose else None
    _launch_gd_multi((psi, tnp, vel), bufs, tg, live, taps, alpha, w_reg, momentum, K,
                     gd_multi_plan(dims, taps.shape[0], _n_sm(dev)), n_inner, 1, mx_sq,
                     e_data=e_data, energy_every=True, e_pre=e_pre, e_reg=e_reg, parts=parts)
    launch_counts["gd_multi"] += 1
    return MultiOut(*out, mx_sq[0], None if e_data is None else e_data[0], e_pre, e_reg)


# kernel E's chunks enqueued per host read of its loop (GdMultiLoop)
GD_MULTI_LAUNCHES = 8
# the fewest z planes of a segment of kernel E's march (gd_tile_plan's min_lz)
GD_MULTI_MIN_LZ = 2


def gd_multi_plan(dims, n_taps: int, n_sm: int = 132) -> dict:
    """Kernel E's tile plan: :func:`gd_tile_plan` with segments down to
    GD_MULTI_MIN_LZ planes, so that a small grid still gives every SM
    several blocks."""
    return gd_tile_plan(dims, n_taps, n_sm, min_lz=GD_MULTI_MIN_LZ)


class GdMultiLoop:
    """The state of one solve's loop on kernel E, the coarse pyramid level's
    ``fused_gd_multi_fold`` loop (sobfu_tpu/solver.py:337-345): chunks of
    n_inner iterations, each the stop rule's unit — the solve stops after
    the first chunk whose LAST norm is at or under thresh, whose LAST energy
    stalls at a check (it1 % stall_window == 0), or that reaches max_iter,
    so a stop overshoots the single-step one by up to n_inner - 1.

    psi f32[3,Z,Y,X]; tnp, tg, live f32[Z,Y,X]. On the card the state lives
    in a ping-pong pair of buffers allocated here, once per solve (psi and
    tnp are copied in), with the ctl and norm rows and the partials;
    :meth:`run` enqueues up to GD_MULTI_LAUNCHES launches, each of which
    tests the stop rule on the card before its first grid sync (the stall
    reference energy carried there), and reads the outcome back once. On
    the CPU each chunk is one :func:`gd_multi` call (its plain version) and
    the same rule is tested on the host (``solver.stall_check``). verbose:
    the record_energy rows, one chunk per call.
    """

    def __init__(self, psi, tnp, tg, live, taps, alpha, w_reg, momentum, K, thresh,
                 max_iter: int, n_inner: int, stall_window: int = 0, stall_rel: float = 0.0,
                 verbose: bool = False):
        import numpy as np

        if stall_window % n_inner:
            raise ValueError(f"stall_window {stall_window} is not a multiple of {n_inner}")
        self.args = (tg, live, taps, alpha, w_reg, momentum, K)
        self.rule = (float(np.float32(thresh)), int(max_iter), int(stall_window),
                     float(stall_rel))
        self.n_inner, self.verbose = int(n_inner), bool(verbose)
        self.count, self.mnorm, self.e_ref, self.stalled = 0, float("inf"), float("inf"), False
        self.cpu = _on_cpu(psi)
        vel = torch.zeros_like(psi) if momentum is not None else None
        if self.cpu:
            self.cur = (psi, tnp, vel)
            return
        dev = psi.device
        dims = tuple(psi.shape[1:])
        other = (torch.empty_like(psi), torch.empty_like(tnp),
                 torch.empty_like(psi) if vel is not None else None)
        self.bufs = ((psi.clone(), tnp.clone(), vel), other)
        self.plan = gd_multi_plan(dims, taps.shape[0], _n_sm(dev))
        M, f32 = GD_MULTI_LAUNCHES, dict(dtype=torch.float32, device=dev)
        # one device buffer for all the host reads of a call: ctl rows
        # 0..M (4 int32 each), then the norm rows (float32 bits)
        self.out = torch.zeros(4 * (M + 1) + M * self.n_inner, dtype=torch.int32, device=dev)
        self.e_data = torch.empty((M, self.n_inner), **f32) if stall_window else None
        self.verb = (torch.empty(self.n_inner, **f32), torch.empty(self.n_inner, **f32)) \
            if verbose else (None, None)
        self.parts = (torch.empty(4 * _n_tiles(dims), **f32) if stall_window or verbose
                      else None)

    @property
    def running(self) -> bool:
        """The loop's predicate: under max_iter, the last norm over thresh,
        no stall."""
        thresh, max_iter = self.rule[:2]
        return self.count < max_iter and self.mnorm > thresh and not self.stalled

    def run(self, n_launch: int):
        """Up to n_launch chunks from the current state (the loop must be
        running). Returns (the chunks that ran, and with verbose the first
        chunk's rows f32[n_inner, 3]: pre-update data energy, pre-update
        regulariser energy, update norm)."""
        import numpy as np

        from sobfu_tpu_torch.solver import stall_check

        if not 1 <= n_launch <= GD_MULTI_LAUNCHES or (self.verbose and n_launch != 1):
            raise ValueError(f"a call is 1..{GD_MULTI_LAUNCHES} launches (1 with verbose), "
                             f"got {n_launch}")
        if not self.running:
            raise ValueError("the loop has stopped")
        tg, live, taps, alpha, w_reg, momentum, K = self.args
        thresh, max_iter, stall_window, stall_rel = self.rule
        n = self.n_inner
        count0 = self.count
        if self.cpu:
            ran, rows, verb, last = 0, np.zeros((n_launch, n), np.float32), None, None
            for k in range(n_launch):
                if self.stalled or self.count >= max_iter or (k and not np.sqrt(last) > thresh):
                    break
                at_check = bool(stall_window) and (self.count + n) % stall_window == 0
                out = gd_multi(*self.cur, tg, live, taps, alpha, w_reg, momentum, K, n,
                               with_energy=at_check, with_verbose=self.verbose)
                self.cur = (out.psi, out.tnp, out.vel)
                rows[k] = out.mx_sq.numpy()
                last = rows[k, -1]
                self.count += n
                ran += 1
                if at_check:
                    self.stalled, self.e_ref = stall_check(float(out.e_data[-1]), self.e_ref,
                                                           self.count, stall_window, stall_rel)
                if self.verbose:
                    verb = torch.stack([out.e_pre, out.e_reg, torch.sqrt(out.mx_sq)], dim=1)
        else:
            M, verb = GD_MULTI_LAUNCHES, None
            ctl = self.out[:4 * (n_launch + 1)].view(n_launch + 1, 4)
            max_sq = self.out[4 * (M + 1):4 * (M + 1) + n_launch * n].view(torch.float32)
            max_sq = max_sq.view(n_launch, n)
            start = np.array([self.count, 1, 0, 0], np.int32)
            start[3] = np.float32(self.e_ref).view(np.int32)
            ctl[0].copy_(torch.from_numpy(start))
            _launch_gd_multi(None, self.bufs, tg, live, taps, alpha, w_reg, momentum, K,
                             self.plan, n, n_launch, max_sq, ctl, thresh, max_iter, stall_window,
                             stall_rel, None if self.e_data is None else self.e_data[:n_launch],
                             False, *self.verb, self.parts)
            if self.verbose:
                verb = torch.stack([*self.verb, torch.sqrt(max_sq[0])], dim=1)
            host = self.out.cpu().numpy()
            end = host[4 * n_launch:4 * n_launch + 4]
            rows = host[4 * (M + 1):4 * (M + 1) + n_launch * n].view(np.float32).reshape(-1, n)
            ran, rest = divmod(int(end[0]) - count0, n)
            if rest or not 0 <= ran <= n_launch:
                raise RuntimeError(f"kernel E's iteration counter is inconsistent: {end}")
            self.count = int(end[0])
            self.stalled = bool(end[2])
            self.e_ref = float(end[3:4].view(np.float32)[0])
            launch_counts["gd_multi"] += ran  # launches are counted where they run: on the card
            empty_launches["gd_multi"] += n_launch - ran
        if ran:
            self.mnorm = float(np.sqrt(rows[ran - 1, -1]))
        host_reads["gd_multi"] += 1
        return ran, verb

    def state(self):
        """(psi, tnp, vel or None) after the iterations run so far."""
        if self.cpu:
            return tuple(self.cur)
        return self.bufs[self.count & 1]


# ---------------------------------------------------------------------------
# A's slab form: one iteration on a z-slab of a z-sharded volume
# ---------------------------------------------------------------------------

# halo rows on either side of a z-slab (the JAX package's _H: the stencils'
# radius 1 and the convolution's radius 3; taps up to 2 * SLAB_HALO - 1)
SLAB_HALO = 4


def _slab_rows(p, z_base: int, z_global: int):
    """The buffer row of slab position p (global row p + z_base clamped
    into the volume) in a slab buffer with SLAB_HALO halo rows."""
    return (p + z_base).clamp(0, z_global - 1) - z_base + SLAB_HALO


def _slab_step_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K, z_base,
                     z_global, live_z0, with_energy):
    """One scene of :func:`gd_iteration_slab_plain` (no scene axis)."""
    from sobfu_tpu_torch.solver import data_energy

    H = SLAB_HALO
    Zl = tnp.shape[-3] - 2 * H
    s = taps.shape[0]
    r = s // 2
    dev = psi.device
    # every buffer row's global row; the z stencils vanish on the volume's end rows
    g = torch.arange(tnp.shape[-3], device=dev) + (z_base - H)
    in_z = ((g > 0) & (g < z_global - 1))[1:-1, None, None]

    def zdiff(f, second: bool):
        up, mid, dn = f[..., 2:, :, :], f[..., 1:-1, :, :], f[..., :-2, :, :]
        out = torch.zeros_like(f)
        out[..., 1:-1, :, :] = torch.where(in_z, up + dn - 2.0 * mid if second
                                           else (up - dn) * 0.5, 0.0)
        return out

    grad = torch.stack([fields.central_diff(tnp, -1), fields.central_diff(tnp, -2),
                        zdiff(tnp, False)])
    lap = -((fields.second_diff(psi, -1) + fields.second_diff(psi, -2)) + zdiff(psi, True))
    dU = (tnp - tg)[None] * grad + w_reg * lap
    own = dU[:, H:H + Zl]
    # the z taps read dU of the clamped global rows (the replicate edge)
    l = torch.arange(Zl, device=dev)
    cz = torch.zeros_like(own)
    for u in range(s):
        cz = cz + taps[u] * dU.index_select(1, _slab_rows(l + (r - u), z_base, z_global))
    dU_S = (fields.conv1d_replicate(own, taps, -1) + fields.conv1d_replicate(own, taps, -2)) + cz
    if momentum is not None:
        vel_new = momentum * vel[:, H:H + Zl] + dU_S
        update = alpha * vel_new
    else:
        vel_new = None
        update = alpha * dU_S
    psi_new = psi[:, H:H + Zl] - update
    if K is None:
        tnp_new = fields.sample_trilinear(live, psi_new)
    else:
        tnp_new = fields._window_sample_zoffset(live, psi_new, z_base, K, False,
                                                vol_z0=live_z0, z_global=z_global)
    max_sq = torch.max(torch.sum(update * update, dim=0))
    out = (psi_new, tnp_new, vel_new, max_sq)
    return out + (data_energy(tg[H:H + Zl], tnp_new),) if with_energy else out


def gd_iteration_slab_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K,
                            z_base: int, z_global: int, live_z0: int = 0, active=None,
                            with_energy: bool = False):
    """:func:`gd_iteration_slab`'s plain version: the whole-volume step
    (:func:`gd_iteration_plain`) of each voxel of the slab, its z stencils,
    replicate edge and live gather decided in global z. An inactive scene
    passes through with max_sq (and energy) 0."""
    S = psi.shape[0]
    H = SLAB_HALO
    Zl = tnp.shape[-3] - 2 * H
    on = [True] * S if active is None else [bool(a) for a in active]
    outs = []
    for k in range(S):
        v = vel[k] if momentum is not None else None
        if on[k]:
            outs.append(_slab_step_plain(psi[k], tnp[k], v, tg[k], live[k], taps, alpha, w_reg,
                                         momentum, K, z_base, z_global, live_z0, with_energy))
        else:
            zero = psi.new_zeros(())
            outs.append((psi[k][:, H:H + Zl], tnp[k][H:H + Zl],
                         None if v is None else v[:, H:H + Zl], zero)
                        + ((zero,) if with_energy else ()))
    return tuple(torch.stack(col) if col[0] is not None else None for col in zip(*outs))


def _check_slab(psi, tnp, vel, tg, live, taps, momentum, K, z_base, z_global, live_z0) -> tuple:
    """Validate the slab form's operands; returns (S, Zl, Y, X, n_taps)."""
    H = SLAB_HALO
    S, _, Zp, Y, X = psi.shape
    Zl = Zp - 2 * H
    dev = psi.device
    if not 1 <= S <= 65535 or Zl < 1:
        raise ValueError(f"psi: shape {tuple(psi.shape)}, expected (S, 3, Zl + {2 * H}, Y, X)")
    if Zp * Y * X >= 2 ** 31 or live.shape[-3] * Y * X >= 2 ** 31:
        raise ValueError("the slab form takes slabs and live volumes under 2^31 voxels")
    s = _check_taps(taps, dev)
    if s > 2 * H - 1:
        raise ValueError(f"the slab form takes at most {2 * H - 1} taps, got {s}")
    if not 0 <= z_base <= z_global - Zl:
        raise ValueError(f"slab rows [{z_base}, {z_base + Zl}) outside a {z_global}-deep volume")
    Zv = live.shape[-3]
    lo = 0 if K is None else max(0, z_base - int(K))
    hi = z_global if K is None else min(z_global, z_base + Zl + int(K))
    if K is not None and int(K) > H:
        raise ValueError(f"window half-width K={K} exceeds the slab halo {H}")
    if not (live_z0 <= lo and live_z0 + Zv >= hi):
        raise ValueError(f"live rows [{live_z0}, {live_z0 + Zv}) miss the rows [{lo}, {hi}) "
                         "the gather reaches")
    for name, t, shape in (("psi", psi, (S, 3, Zp, Y, X)), ("tnp", tnp, (S, Zp, Y, X)),
                           ("tg", tg, (S, Zp, Y, X)), ("live", live, (S, Zv, Y, X))):
        _check(name, t, shape, dev)
    if momentum is not None:
        _check("vel", vel, (S, 3, Zp, Y, X), dev)
    return S, Zl, Y, X, s


def _launch_slab(bufs, tg, live, taps, alpha, w_reg, momentum, K, thresh, ctl, max_prev,
                 max_rows, group: int, n_groups: int, parts, e, n_slabs: int, n: int,
                 z_base: int, z_global: int, live_z0: int, plan: dict,
                 copy_frozen: bool = False) -> None:
    """Enqueue n launches of A's slab form (sobfu_gd_slab_iterations) on the
    ping-pong buffers bufs = ((psi, tnp, vel), (psi, tnp, vel)) of card
    group ``group`` of n_groups (n_slabs slabs); ctl holds rows 0..n,
    max_rows rows 0..n-1 of [n_groups, S] words, max_prev the row before
    (None: no test at launch 0). Nothing is counted here."""
    from sobfu_tpu_torch.ops._build import library

    (psi0, tnp0, vel0), (psi1, tnp1, vel1) = bufs
    S, _, Zp, Y, X = psi0.shape
    dev = psi0.device
    has_vel = momentum is not None
    for name, t, rows, words in (("ctl", ctl, n + 1, S), ("max_rows", max_rows, n, n_groups * S)):
        if t.shape[0] < rows or t[0].numel() != words or not t.is_contiguous():
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {rows} rows of {words}")
    with torch.cuda.device(dev):
        rc = library().sobfu_gd_slab_iterations(
            psi0.data_ptr(), psi1.data_ptr(), tnp0.data_ptr(), tnp1.data_ptr(),
            vel0.data_ptr() if has_vel else None, vel1.data_ptr() if has_vel else None,
            tg.data_ptr(), live.data_ptr(), taps.data_ptr(), taps.shape[0],
            float(alpha), float(w_reg), float(momentum) if has_vel else 0.0, float(thresh),
            ctl.data_ptr(), _ptr(max_prev), max_rows.data_ptr(), group, n_groups,
            _ptr(parts), _ptr(e), n_slabs, n, S, Zp - 2 * SLAB_HALO, Y, X, SLAB_HALO, z_base,
            z_global, live_z0, live.shape[-3], _K(K), plan["LZ"], int(copy_frozen),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gd_iteration_slab: CUDA launch failed with error {rc}")


def gd_iteration_slab(psi, tnp, vel, tg, live, taps, alpha: float, w_reg: float,
                      momentum: Optional[float], K: Optional[int], z_base: int, z_global: int,
                      live_z0: int = 0, active=None, with_energy: bool = False):
    """Kernel A's slab form: one iteration on z-slab rows [z_base, z_base +
    Zl) of a z_global-deep volume, for S scenes, in one launch (two more
    small ones with the energy; counted once).

    psi f32[S,3,Zl+2H,Y,X], tnp and tg f32[S,Zl+2H,Y,X] (H = SLAB_HALO):
    the slab's rows with H rows of the neighbouring slabs on either side
    (what a halo exchange puts there; the rows past the volume's ends are
    never read); vel the same shape as psi when momentum is set, else
    ignored. live f32[S,Zv,Y,X] holds global rows [live_z0, live_z0 + Zv)
    (rows outside the volume are never read): the whole volume (the exact
    warp, K None, needs it) or at least the slab and K rows on either side.
    taps: odd, at most 2H - 1. active: bool
    [S] on the device (None: every scene runs); an inactive scene keeps its
    state and reports 0. Returns (psi', tnp', vel' or None, max_sq f32[S])
    for the slab's own rows (f32[S,3,Zl,Y,X] views); with_energy appends
    0.5 sum (tg - tnp')^2 over the slab's rows, f32[S]. Each voxel equals
    :func:`gd_iteration` on the whole volume bit for bit (the same
    arithmetic, every boundary decided in global z).
    """
    z_base, z_global, live_z0 = int(z_base), int(z_global), int(live_z0)
    S, Zl, Y, X, _ = _check_slab(psi, tnp, vel, tg, live, taps, momentum, K, z_base, z_global,
                                 live_z0)
    if _on_cpu(psi):
        return gd_iteration_slab_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K,
                                       z_base, z_global, live_z0, active, with_energy)
    dev = psi.device
    H = SLAB_HALO
    has_vel = momentum is not None
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty_like(psi), torch.empty_like(tnp), torch.empty_like(psi) if has_vel else None)
    ctl = torch.zeros((2, S), dtype=torch.int32, device=dev)
    if active is not None:
        ctl[0] = torch.as_tensor(active, device=dev).to(torch.int32) - 1
    max_row = torch.empty((1, S), **f32)
    parts = torch.empty((S, _n_tiles((Zl, Y, X))), **f32) if with_energy else None
    e = torch.empty((S,), **f32) if with_energy else None
    _launch_slab(((psi, tnp, vel if has_vel else None), out), tg, live, taps, alpha, w_reg,
                 momentum, K, 0.0, ctl, None, max_row, 0, 1, parts, e, 1, 1, z_base, z_global,
                 live_z0, gd_tile_plan((Zl, Y, X), taps.shape[0], _n_sm(dev)), copy_frozen=True)
    launch_counts["gd_iteration_slab"] += 1
    own = (out[0][:, :, H:H + Zl], out[1][:, H:H + Zl],
           out[2][:, :, H:H + Zl] if has_vel else None, max_row[0])
    return own + (e,) if with_energy else own


def _exchange_rows(slabs, H: int) -> int:
    """Fill the H halo rows on either side of each slab buffer f32[...,
    Zl+2H, Y, X] (a list in z order, any devices) from its neighbours' own
    rows; the outer rows of the end slabs are left as they are. A copy
    between two cards is ordered after both cards' current streams (torch's
    cross-device copy records an event on each side). Returns the bytes
    copied."""
    n = 0
    for lo, hi in zip(slabs[:-1], slabs[1:]):
        Zl = lo.shape[-3] - 2 * H
        hi[..., :H, :, :].copy_(lo[..., Zl:Zl + H, :, :])
        lo[..., Zl + H:, :, :].copy_(hi[..., H:2 * H, :, :])
        n += 2 * hi[..., :H, :, :].numel() * hi.element_size()
    return n


def card_groups(devices) -> list:
    """The card groups of a z-slab list: each run of consecutive slabs on one
    device, as a [first, stop) pair of slab indices, in z order. A pure
    function of the devices: ``[a, a, b, b]`` gives two groups, ``[a, b,
    a]`` three."""
    out = []
    for j, d in enumerate(devices):
        if out and devices[out[-1][0]] == d:
            out[-1] = (out[-1][0], j + 1)
        else:
            out.append((j, j + 1))
    return out


def _join_padded(ts, H: int):
    """Halo-padded z-slabs f32[..., Zl+2H, Y, X], consecutive in z, as one
    buffer: their own rows, the first's lower and the last's upper halo."""
    if len(ts) == 1:
        return ts[0]
    Zl = ts[0].shape[-3] - 2 * H
    return torch.cat([ts[0][..., :H + Zl, :, :]] + [t[..., H:H + Zl, :, :] for t in ts[1:-1]]
                     + [ts[-1][..., H:, :, :]], dim=-3)


class GdSlabLoop:
    """The gradient-descent loop of a z-sharded solve on kernel A's slab
    form, advanced in chunks with one host read per chunk: the sharded
    counterpart of :class:`GdLoop` (``run`` and ``state`` take and return
    the same things).

    psi: a list over the z-slabs, in z order, of f32[S,3,Zl,Y,X] on each
    slab's device; tnp the same of f32[S,Zl,Y,X]; tg the slabs with H
    halo rows (f32[S,Zl+2H,Y,X], exchanged once per solve by the caller);
    live the same, or with K None each slab's copy of the whole volume.
    Slab j holds global rows [j Zl, (j + 1) Zl) of a z_global-deep volume.

    The slabs run in card groups (:func:`card_groups`, which the tests
    patch to force another split of one device's slabs). Each group's state
    lives in one halo-padded ping-pong pair of its rows, allocated here once
    per solve (tg and live joined the same way), so a slab's neighbours'
    rows inside the group are read in place. One group (the z axis on one
    card): :meth:`run` is one call of n launches (sobfu_gd_slab_iterations),
    each testing the stop rule on the card, and one host read. Several: per
    iteration the halo rows of psi and tnp are copied between neighbouring
    groups (H rows each way), each group launches once, and each group's
    norm words are copied to the other cards, so that every card tests the
    max over ALL groups (the pmax). Grouping saves launches and copies only
    where several slabs share a card: the default layout of
    ``parallel.zshard.make_mesh`` puts one slab on each card, where every
    group is one slab. The energy is each slab's, summed on the host (the
    psum). On the CPU the same groups run :func:`gd_iteration_slab_plain`.
    ``halo_bytes`` counts the bytes copied between groups, ``iterations``
    the iterations enqueued and ``calls`` the kernel calls made; launches
    are counted per group launch.
    """

    def __init__(self, psi, tnp, tg, live, taps, alpha, w_reg, momentum, K, thresh,
                 z_global: int, energy: bool = False):
        import numpy as np

        H = SLAB_HALO
        self.n = len(psi)
        S, _, Zl, Y, X = psi[0].shape
        self.Zl, self.z_global = Zl, int(z_global)
        devs = [p.device for p in psi]
        self.groups = card_groups(devs)
        if [j for a, b in self.groups for j in range(a, b)] != list(range(self.n)) or any(
                len(set(devs[a:b])) != 1 for a, b in self.groups):
            raise ValueError(f"card groups {self.groups} do not split the slabs' devices {devs}")
        self.dev = [devs[a] for a, _ in self.groups]
        self.z_base = [a * Zl for a, _ in self.groups]
        self.live_z0 = [0 if K is None else zb - H for zb in self.z_base]
        # each group's taps, tg and live on its device
        self.taps = [taps if taps.device == d else taps.to(d) for d in self.dev]
        self.tg = [_join_padded(tg[a:b], H) for a, b in self.groups]
        self.live = [live[a] if K is None else _join_padded(live[a:b], H) for a, b in self.groups]
        self.args = (alpha, w_reg, momentum, K, float(thresh))
        self.count = np.zeros(S, np.int64)
        self.halo_bytes = self.iterations = self.calls = 0
        self.cpu = _on_cpu(psi[0])
        has_vel = momentum is not None

        def padded(ts):
            buf = ts[0].new_zeros(ts[0].shape[:-3] + (len(ts) * Zl + 2 * H, Y, X))
            for j, t in enumerate(ts):
                buf[..., H + j * Zl:H + (j + 1) * Zl, :, :] = t
            return buf

        cur = []
        for g, (a, b) in enumerate(self.groups):
            p = padded(psi[a:b])
            cur.append((p, padded(tnp[a:b]), torch.zeros_like(p) if has_vel else None))
            _check_slab(*cur[g][:3], self.tg[g], self.live[g], self.taps[g], momentum, K,
                        self.z_base[g], self.z_global, self.live_z0[g])
        if self.cpu:
            self.cur = cur
            return
        self.bufs = [(c, tuple(None if a is None else torch.empty_like(a) for a in c))
                     for c in cur]
        n_sm = _n_sm(self.dev[0])
        self.plans = [gd_tile_plan((c[1].shape[-3] - 2 * H, Y, X), taps.shape[0], n_sm)
                      for c in cur]
        # per card: ctl rows 0..GD_CHUNK (int32), the norm rows [GD_CHUNK][groups][S]
        # and every slab's energies [n][S] (float32 bits), read at once
        self.devices = list(dict.fromkeys(self.dev))
        self.ctl_rows = (GD_CHUNK + 1) * S
        G = len(self.groups)
        self.out = {d: torch.zeros(self.ctl_rows + (GD_CHUNK * G + self.n) * S,
                                   dtype=torch.int32, device=d) for d in self.devices}
        self.parts = ([torch.empty((b - a, S, _n_tiles((Zl, Y, X))), dtype=torch.float32,
                                   device=d) for (a, b), d in zip(self.groups, self.dev)]
                      if energy else None)

    def _views(self, d, S: int):
        """(ctl [GD_CHUNK+1, S], norm rows [GD_CHUNK, groups, S], energies
        [n, S]) of card d's control buffer."""
        out, G = self.out[d], len(self.groups)
        rest = out[self.ctl_rows:].view(torch.float32)
        return (out[:self.ctl_rows].view(GD_CHUNK + 1, S),
                rest[:GD_CHUNK * G * S].view(GD_CHUNK, G, S),
                rest[GD_CHUNK * G * S:].view(self.n, S))

    def _launch(self, g: int, ctl, prev, rows, n: int, energy) -> None:
        """n launches of group g (ctl from row 0, its norm rows from
        rows[0], prev the row before or None); energy: the group's slabs'
        rows of the energies, or None."""
        alpha, w_reg, momentum, K, thresh = self.args
        a, b = self.groups[g]
        _launch_slab(self.bufs[g], self.tg[g], self.live[g], self.taps[g], alpha, w_reg,
                     momentum, K, thresh, ctl, prev, rows, g, len(self.groups),
                     None if energy is None else self.parts[g], energy, b - a, n,
                     self.z_base[g], self.z_global, self.live_z0[g], self.plans[g])
        self.calls += 1

    def _energies_plain(self, on):
        """Each slab's data energy f32[n, S] from the CPU groups' state (0
        for a scene that did not run)."""
        import numpy as np

        from sobfu_tpu_torch.solver import data_energy

        H, Zl = SLAB_HALO, self.Zl
        e = np.zeros((self.n, on.shape[0]), np.float32)
        for g, (a, b) in enumerate(self.groups):
            tnp, tg = self.cur[g][1], self.tg[g]
            for j in range(b - a):
                rows = slice(H + j * Zl, H + (j + 1) * Zl)
                for s in np.flatnonzero(on):
                    e[a + j, s] = data_energy(tg[s, rows], tnp[s, rows]).numpy()
        return e

    def run(self, n: int, active, with_energy: bool = False):
        """Up to n (<= GD_CHUNK) iterations of every slab from the current
        state; active bool[S] (host) names the scenes that run. Returns
        (done int32[S], max_sq float32[n, S] over all slabs, the energy
        float32[S] summed over the slabs or None) on the host."""
        import numpy as np

        if not 1 <= n <= GD_CHUNK:
            raise ValueError(f"a chunk is 1..{GD_CHUNK} iterations, got {n}")
        active = np.asarray(active, bool)
        alpha, w_reg, momentum, K, thresh = self.args
        H, S, G = SLAB_HALO, active.shape[0], len(self.groups)
        counts = self.count[active]
        if counts.size and (counts != counts[0]).any():
            raise RuntimeError("the running scenes of a slab loop differ in their iterations")
        c0 = int(counts[0]) if counts.size else 0
        if self.cpu:
            on = active.copy()
            done = np.zeros(S, np.int32)
            rows = np.zeros((n, S), np.float32)
            e = np.zeros(S, np.float32) if with_energy else None
            for k in range(n):
                if k:
                    on &= np.sqrt(rows[k - 1]) > np.float32(thresh)
                if not on.any():
                    break
                for field in (0, 1):
                    self.halo_bytes += _exchange_rows([c[field] for c in self.cur], H)
                self.iterations += 1
                outs = [gd_iteration_slab_plain(*c, self.tg[g], self.live[g], self.taps[g],
                                                alpha, w_reg, momentum, K, self.z_base[g],
                                                self.z_global, self.live_z0[g],
                                                torch.as_tensor(on))
                        for g, c in enumerate(self.cur)]
                for c, o in zip(self.cur, outs):
                    for buf, new in zip(c, o[:3]):
                        if buf is not None:
                            buf[..., H:buf.shape[-3] - H, :, :] = new
                rows[k] = np.max([o[3].numpy() for o in outs], axis=0)
                done += on
                if with_energy and k == n - 1:
                    e = self._energies_plain(on).sum(axis=0, dtype=np.float32)
        else:
            if with_energy and self.parts is None:
                raise ValueError("this GdSlabLoop was made without energy")
            start = _chunk_start(self.count, active)
            views = {d: self._views(d, S) for d in self.devices}
            for ctl, _, _ in views.values():
                ctl[0].copy_(start)
            if G == 1:  # the whole z axis on one card: one call, n launches
                ctl, mx, ev = views[self.dev[0]]
                self._launch(0, ctl, None, mx, n, ev if with_energy else None)
                self.iterations += n
            else:  # a launch a group and iteration, the halo rows copied between groups
                for k in range(n):
                    par = (c0 + k) & 1
                    for field in (0, 1):
                        self.halo_bytes += _exchange_rows([bufs[par][field] for bufs in self.bufs],
                                                          H)
                    self.iterations += 1
                    last = with_energy and k == n - 1
                    for g, (a, b) in enumerate(self.groups):
                        ctl, mx, ev = views[self.dev[g]]
                        self._launch(g, ctl[k:], mx[k - 1] if k else None, mx[k:k + 1], 1,
                                     ev[a:b] if last else None)
                    if len(self.devices) > 1:  # every card tests the max over all groups
                        for g, src in enumerate(self.dev):
                            for d in self.devices:
                                if d != src:
                                    views[d][1][k, g].copy_(views[src][1][k, g])
            lead = self.devices[0]
            if with_energy and len(self.devices) > 1:  # the energies to the first card
                for (a, b), d in zip(self.groups, self.dev):
                    if d != lead:
                        views[lead][2][a:b].copy_(views[d][2][a:b])
            host = self.out[lead].cpu().numpy()
            done = _chunk_end("gd_iteration_slab", host[n * S:(n + 1) * S], self.count, n, G)
            rest = host[self.ctl_rows:].view(np.float32)
            rows = rest[:n * G * S].reshape(n, G, S).max(axis=1)
            e = (rest[GD_CHUNK * G * S:].reshape(self.n, S).sum(axis=0, dtype=np.float32)
                 if with_energy else None)
        self.count += done
        host_reads["gd_iteration_slab"] += 1
        return done, rows, e

    def state(self):
        """Per slab, (psi f32[S,3,Zl,Y,X], tnp f32[S,Zl,Y,X], vel or None):
        the slabs' own rows (views of the groups' buffers) after the
        iterations run so far."""
        H, Zl = SLAB_HALO, self.Zl
        if self.cpu:
            bufs = self.cur
        else:
            par = self.count & 1
            if (par == par[0]).all():
                bufs = [b[int(par[0])] for b in self.bufs]
            else:
                bufs = [tuple(None if x is None else torch.stack(
                    [(y if p else x)[s] for s, p in enumerate(par)]) for x, y in zip(*b))
                    for b in self.bufs]
        return [tuple(None if t is None else t[..., H + j * Zl:H + (j + 1) * Zl, :, :]
                      for t in buf)
                for buf, (a, b) in zip(bufs, self.groups) for j in range(b - a)]
