"""The CUDA kernels of the frame loop and their plain torch versions.

==================  ==========================================  =============
wrapper             replaces (sobfu_tpu/ops/pallas_kernels.py)  source
==================  ==========================================  =============
gd_iteration (A)    fused_gd_iteration_pp :2443 (+ the db /     csrc/gd_iteration.cu
                    fold / stacked / step layouts)
gd_iteration_scenes fused_gd_iteration_db_padded :1075 (the     csrc/gd_iteration.cu
(A over scenes)     scene-batched frame step's kernel)
warp (B)          window_warp_pallas :478,                    csrc/warp.cu
                    window_warp_pallas_mixed :508
inverse_fixed_point estimate_inverse_window_pallas_multi :3061  csrc/inverse.cu
(C)                 (+ estimate_inverse_window_pallas :1883)
warp_fuse (D)       window_warp_fuse_pallas :607                csrc/warp_fuse.cu
gd_multi (E)        fused_gd_multi_fold :2805                   csrc/gd_multi.cu
compose_weight (F)  compose_weight_pallas :3223                 csrc/compose_weight.cu
warp_field3 (B,     window_warp_field3_pallas :3309             csrc/warp.cu
C=3)
==================  ==========================================  =============

Each wrapper takes the JAX package's layouts and a window half-width ``K``
(None = the exact sampler, no displacement clamp). Dispatch is by device:
CPU tensors go to the plain torch version (``*_plain``, built from
:mod:`sobfu_tpu_torch.fields`); CUDA tensors launch the kernel on the
current stream or raise — there is no fallback. ``launch_counts`` counts
kernel launches per wrapper and is touched nowhere else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from sobfu_tpu_torch import fields
from sobfu_tpu_torch.tsdf import fuse_volumes

launch_counts = {
    "gd_iteration": 0, "warp": 0, "inverse_fixed_point": 0, "warp_fuse": 0, "gd_multi": 0,
    "compose_weight": 0, "warp_field3": 0, "gd_iteration_scenes": 0,
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
}

# voxels per tile of the kernels' reductions (csrc/sampling.cuh kBlock)
TILE = 256


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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


def _check(name: str, t: torch.Tensor, shape, device) -> int:
    """Validate a kernel operand; returns its device pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
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
    sampled at pos, the taps computed once for all three (the compositive
    composition psi0 o (id + delta)). K None = the exact sampler. Counted
    under its own name, apart from :func:`warp`."""
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


def inverse_fixed_point(psi, iters: int, K: Optional[int], init=None):
    """Kernel C: ``iters`` steps of q <- v - disp(psi)(q) from ``init``
    (None = identity) in one launch."""
    if _on_cpu(psi):
        return inverse_fixed_point_plain(psi, iters, K, init)
    Z, Y, X = psi.shape[1:]
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


def _launch_gd(kernel: str, lead: tuple, psi, tnp, vel, tg, live, taps, alpha, w_reg,
               momentum, K, active, with_energy: bool):
    """A's launch, counted under ``kernel``: lead () for one scene (psi
    f32[3,Z,Y,X]; the norm and energy 0-dim), (S,) for S scenes (psi
    f32[S,3,Z,Y,X]; the norms and energies f32[S]). active None = every
    scene runs."""
    S = lead[0] if lead else 1
    Z, Y, X = psi.shape[-3:]
    vols = lead + (Z, Y, X)
    flds = lead + (3, Z, Y, X)
    dev = psi.device
    if not 1 <= S <= 65535:
        raise ValueError(f"{kernel} takes 1..65535 scenes, got {S}")
    if active is not None:
        if active.device != dev or active.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"active: {active.dtype} on {active.device}, expected bool on {dev}")
        if tuple(active.shape) != (S,) or not active.is_contiguous():
            raise ValueError(f"active: shape {tuple(active.shape)}, expected ({S},) contiguous")
    s = _check_taps(taps, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dU = torch.empty_like(psi)
    psi_out = torch.empty_like(psi)
    tnp_out = torch.empty_like(tnp)
    vel_out = torch.empty_like(psi) if momentum is not None else None
    max_sq = torch.empty(lead, **f32)
    parts = torch.empty(lead + (_n_tiles((Z, Y, X)),), **f32) if with_energy else None
    e = torch.empty(lead, **f32) if with_energy else None
    _launch(
        kernel, "sobfu_gd_iteration", dev,
        _check("psi", psi, flds, dev),
        _check("tnp", tnp, vols, dev),
        None if momentum is None else _check("vel", vel, flds, dev),
        _check("tg", tg, vols, dev),
        _check("live", live, vols, dev),
        taps.data_ptr(), s,
        float(alpha), float(w_reg), 0.0 if momentum is None else float(momentum),
        _ptr(active),
        dU.data_ptr(), psi_out.data_ptr(), tnp_out.data_ptr(), _ptr(vel_out),
        max_sq.data_ptr(), _ptr(parts), _ptr(e), S, Z, Y, X, _K(K),
    )
    if with_energy:
        return psi_out, tnp_out, vel_out, max_sq, e
    return psi_out, tnp_out, vel_out, max_sq


def gd_iteration(
    psi, tnp, vel, tg, live, taps, alpha: float, w_reg: float,
    momentum: Optional[float], K: Optional[int], with_energy: bool = False,
):
    """Kernel A: one gradient-descent iteration (two launches, three with the
    energy; counted once): the launch of :func:`gd_iteration_scenes` with
    one scene and no scene axis.

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
    """Kernel A over a leading scene axis: one launch of each of A's bodies
    for all S scenes (counted once, apart from :func:`gd_iteration`).

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


def gd_multi(
    psi, tnp, vel, tg, live, taps, alpha: float, w_reg: float,
    momentum: Optional[float], K: Optional[int], n_inner: int,
    with_energy: bool = False, with_verbose: bool = False,
) -> MultiOut:
    """Kernel E: n_inner iterations of kernel A in one cooperative launch.

    Operands as :func:`gd_iteration`. Equal bit for bit to n_inner chained
    gd_iteration calls: state, velocity, every mx_sq row and every e_data
    row. with_verbose adds the pre-update data and regulariser energies of
    each iteration (the rows record_energy keeps).
    """
    n_inner = int(n_inner)
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    if _on_cpu(psi):
        return gd_multi_plain(psi, tnp, vel, tg, live, taps, alpha, w_reg, momentum, K,
                              n_inner, with_energy, with_verbose)
    Z, Y, X = psi.shape[1:]
    dims = (Z, Y, X)
    dev = psi.device
    s = _check_taps(taps, dev)
    has_vel = momentum is not None
    f32 = dict(dtype=torch.float32, device=dev)
    n_tiles = _n_tiles(dims)

    def rows(on):
        return torch.empty(n_inner, **f32) if on else None

    def tiles(on):
        return torch.empty(n_tiles, **f32) if on else None

    psi_out, psi_tmp = torch.empty_like(psi), torch.empty_like(psi)
    tnp_out, tnp_tmp = torch.empty_like(tnp), torch.empty_like(tnp)
    vel_out = torch.empty_like(psi) if has_vel else None
    vel_tmp = torch.empty_like(psi) if has_vel else None
    dU = torch.empty_like(psi)
    mx_sq = rows(True)
    e_data, e_pre, e_reg = rows(with_energy), rows(with_verbose), rows(with_verbose)
    part_data, part_pre, part_reg = tiles(with_energy), tiles(with_verbose), tiles(with_verbose)
    _launch(
        "gd_multi", "sobfu_gd_multi", dev,
        _check("psi", psi, (3,) + dims, dev),
        _check("tnp", tnp, dims, dev),
        _check("vel", vel, (3,) + dims, dev) if has_vel else None,
        _check("tg", tg, dims, dev),
        _check("live", live, dims, dev),
        taps.data_ptr(), s,
        float(alpha), float(w_reg), float(momentum) if has_vel else 0.0,
        psi_out.data_ptr(), tnp_out.data_ptr(), _ptr(vel_out),
        psi_tmp.data_ptr(), tnp_tmp.data_ptr(), _ptr(vel_tmp), dU.data_ptr(),
        mx_sq.data_ptr(), _ptr(e_data), _ptr(e_pre), _ptr(e_reg),
        _ptr(part_data), _ptr(part_pre), _ptr(part_reg),
        n_inner, Z, Y, X, _K(K),
    )
    return MultiOut(psi_out, tnp_out, vel_out, mx_sq, e_data, e_pre, e_reg)
