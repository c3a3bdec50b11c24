"""Sobolev-gradient warp-field solver (additive and compositive modes, with
the pyramid).

PyTorch counterpart of ``sobfu_tpu.solver``. Per iteration
(reference solver.cu:114-193):
  grad = central-difference gradient of (phi_n o psi)
  L    = negated 6-neighbour Laplacian of psi
  dU   = (phi_n_psi - phi_global) * grad + w_reg * L
  dU_S = conv_x(dU) + conv_y(dU) + conv_z(dU)   (a SUM of 1-D filters)
  psi -= alpha * dU_S ; phi_n_psi = warp(phi_n, psi)
  stop when max ||alpha * dU_S|| <= max_update_norm or after max_iter
Afterwards: psi_inv by the fixed point, and the tail warps.

On a CUDA device every warp, iteration and inverse runs through the kernels
of :mod:`sobfu_tpu_torch.ops.kernels`; on the CPU through their plain torch
versions. torch has no on-device while_loop: the stop test reads the max
norm on the host after every iteration (every chunk of kernel E), which
keeps JAX's stopping semantics (the same ``iters``). The coarse-to-fine
pyramid (:func:`estimate_psi_pyramid`) warm-starts the fine solve from
2x-downsampled levels (helpers in :mod:`sobfu_tpu_torch.pyramid`). The
compositive mode (:func:`estimate_psi_compositive`) solves each frame's
increment on top of the accumulated field and composes the two (kernel F,
or kernel B on three channels).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sobfu_tpu_torch import fields
from sobfu_tpu_torch.config import Params
from sobfu_tpu_torch.ops import kernels


# ---------------------------------------------------------------------------
# Sobolev filter (numpy; identical to sobfu_tpu.solver)
# ---------------------------------------------------------------------------

# Published 1-D decompositions of the Sobolev filter for the (s, lambda)
# pairs shipped with the method (reference src/sobfu/solver.cpp:160-262).
_FILTER_TABLE = {
    (3, 0.1): [0.06537, 0.99572, 0.06537],
    (7, 0.05): [0.00006, 0.00015, 0.03917, 0.99846, 0.03917, 0.00015, 0.00006],
    (7, 0.1): [0.00030, 0.00441, 0.06571, 0.99565, 0.06571, 0.00441, 0.00030],
    (7, 0.2): [0.00120, 0.01094, 0.10204, 0.98941, 0.10204, 0.01094, 0.00120],
    (7, 0.4): [0.00169, 0.01312, 0.10927, 0.98781, 0.10927, 0.01312, 0.00169],
    (9, 0.05): [0.000003, 0.00006, 0.00155, 0.03917, 0.99846,
                0.03917, 0.00155, 0.00006, 0.000003],
    (9, 0.1): [0.00002, 0.00030, 0.00441, 0.06571, 0.99565,
               0.06571, 0.00441, 0.00030, 0.00002],
    (11, 0.1): [0.0000015, 0.00002, 0.00030, 0.00441, 0.06571, 0.99565,
                0.06571, 0.00441, 0.00030, 0.00002, 0.0000015],
}


def solve_sobolev_filter_3d(s: int, lam: float) -> np.ndarray:
    """Solve (Id - lambda * L) S = e_center on an s^3 grid -> f32[s,s,s]
    (reference get_3d_sobolev_filter, solver.cpp:107-158)."""
    n = s ** 3
    idx = np.arange(n)
    ix = idx % s
    iy = (idx // s) % s
    iz = idx // (s * s)
    L = -6.0 * np.eye(n)
    for dx, dy, dz in [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]:
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = (jx >= 0) & (jx < s) & (jy >= 0) & (jy < s) & (jz >= 0) & (jz < s)
        L[idx[ok], (jx + jy * s + jz * s * s)[ok]] = 1.0
    e = np.zeros(n)
    e[int(np.floor(n / 2.0))] = 1.0
    S = np.linalg.solve(np.eye(n) - lam * L, e)
    return S.reshape(s, s, s).astype(np.float32)


def decompose_filter_1d(S3: np.ndarray) -> np.ndarray:
    """Leading rank-1 factor of a (near-separable) 3-D filter -> unit-L2 taps."""
    s = S3.shape[0]
    U, _, _ = np.linalg.svd(S3.reshape(s, s * s), full_matrices=False)
    v = U[:, 0]
    if v[s // 2] < 0:
        v = -v
    return v.astype(np.float32)


def sobolev_filter_1d(s: int, lam: float) -> np.ndarray:
    """Unit-sum 1-D Sobolev filter taps (published table when available,
    else the (Id - lambda L) solve)."""
    key = (int(s), round(float(lam), 6))
    if key in _FILTER_TABLE:
        taps = np.asarray(_FILTER_TABLE[key], dtype=np.float32)
    else:
        taps = decompose_filter_1d(solve_sobolev_filter_3d(int(s), float(lam)))
    return (taps / taps.sum()).astype(np.float32)


# ---------------------------------------------------------------------------
# energies / reductions (reference src/sobfu/reductor.cpp)
# ---------------------------------------------------------------------------


def data_energy(tsdf_global: torch.Tensor, tsdf_n_psi: torch.Tensor) -> torch.Tensor:
    """0.5 * sum (phi_global - phi_n_psi)^2 (reductor.cpp:38-43)."""
    d = tsdf_global - tsdf_n_psi
    return 0.5 * torch.sum(d * d)


def reg_energy_sobolev(psi: torch.Tensor) -> torch.Tensor:
    """0.5 * sum ||J(disp(psi))||_F^2 (reductor.cpp:45-50)."""
    J = fields.deformation_jacobian(psi)
    return 0.5 * torch.sum(J * J)


def window_guard_margin(psi: torch.Tensor, K: int = 1) -> torch.Tensor:
    """Scalar margin (voxels) by which psi's displacement stays inside the
    window-K sampler's exactness interval (-K, K+1) per component
    (``sobfu_tpu.solver.window_guard_margin``): positive = every sample
    exact, negative = the window warp clamped somewhere. Its recipe: redo a
    frame at K+1 when the margin is under 0.5. Nothing in the frame loop
    calls it, in either package."""
    disp = fields.displacement(psi)
    lo = torch.min(disp) - float(-K)  # distance above -K
    hi = float(K + 1) - torch.max(disp)  # distance below K+1
    return torch.minimum(lo, hi)


def max_update_norm(updates: torch.Tensor):
    """(max ||update||, flat argmax index) over f32[3,Z,Y,X] (reductor.cu:342-455)."""
    norm_sq = torch.sum(updates * updates, dim=0).reshape(-1)
    idx = torch.argmax(norm_sq)
    return torch.sqrt(norm_sq[idx]), idx


def sobolev_smooth(dU: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Sum of three axis-wise 1-D replicate-pad convolutions of the SAME
    input (solver.cu:290,366,443) — not a separable tensor product."""
    conv = fields.conv1d_replicate
    return conv(dU, taps, -1) + conv(dU, taps, -2) + conv(dU, taps, -3)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------


def stall_check(e_now, e_ref, it1: int, stall_window: int, stall_rel: float):
    """The data-energy stall stop at check iteration it1 (sobfu_tpu/solver.py
    :673-693), in float32: (stalled, the new reference energy)."""
    e_now = np.float32(e_now)
    stalled = bool(
        it1 >= 2 * stall_window
        and np.float32(e_ref) - e_now < np.float32(stall_rel) * abs(e_now)
    )
    return stalled, float(e_now)


class SolveResult(NamedTuple):
    psi: torch.Tensor
    psi_inv: torch.Tensor
    tsdf_n_psi: torch.Tensor
    weight_n_psi: torch.Tensor
    tsdf_global_psi_inv: torch.Tensor
    weight_global_psi_inv: torch.Tensor
    iters: int                 # all iterations, coarse pyramid levels included
    max_norm: float
    energy: torch.Tensor
    coarse_iters: int = 0      # the coarse levels' share of iters


def estimate_psi(
    psi: torch.Tensor,
    tsdf_global: torch.Tensor,
    weight_global: torch.Tensor,
    tsdf_n: torch.Tensor,
    weight_n: torch.Tensor,
    taps,
    alpha: float,
    w_reg: float,
    max_iter: int,
    max_update_norm_thresh: float,
    psi_inv0: Optional[torch.Tensor] = None,
    *,
    record_energy: bool = False,
    energy_cap: int = 0,
    inverse_iters: int = 48,
    warp_window: Optional[int] = None,
    momentum: Optional[float] = None,
    stall_window: int = 0,
    stall_rel: float = 1e-3,
    skip_tails: bool = False,
    skip_inv_warps: bool = False,
    skip_weight_warp: bool = False,
    inner_steps: int = 0,
    inv_multigrid: bool = False,
    inv_coarse: bool = False,
) -> SolveResult:
    """The full warp-field solve for one frame (``sobfu_tpu.solver.
    estimate_psi``, additive path).

    warp_window: K of the window sampler for every warp, iteration and
    inverse; None = exact sampler. psi_inv0 warm-starts the inverse fixed
    point (None = identity). momentum: heavy-ball coefficient (None = plain
    GD). record_energy: per-iteration rows (pre-update data energy,
    pre-update reg energy, update norm). stall_window / stall_rel: the
    data-energy stall stop (0 = off); the energy comes from kernel A's (or
    E's) own output and is read on the host only at check iterations. On
    kernel A the loop runs in chunks of up to ``kernels.GD_CHUNK``
    iterations with the norm test on the device and one host read a chunk
    (``kernels.GdLoop``): the iteration count is the per-iteration loop's.
    skip_tails: no inverse and no tail warps (coarse pyramid levels):
    psi_inv = psi and the volumes pass through. skip_inv_warps: return
    pass-throughs for phi_global o psi_inv (the no-log loop).
    skip_weight_warp: return the unwarped weight_n (the caller fuses with
    the warp_fuse kernel).

    inner_steps > 1: run the loop in chunks of that many iterations, each
    one launch of kernel E (the coarse pyramid level's
    ``fused_gd_multi_fold``), up to ``kernels.GD_MULTI_LAUNCHES`` launches
    per host read (``kernels.GdMultiLoop``). The stop tests read the
    chunk's LAST norm and energy at ``iter + inner_steps``, so a mid-chunk
    stop overshoots by up to inner_steps - 1 iterations
    (sobfu_tpu/solver.py:337-345); needs stall_window % inner_steps == 0.
    The caller applies JAX's preconditions (Solver, estimate_psi_pyramid).

    inv_multigrid: the inverse is :func:`pyramid.estimate_inverse_multigrid`
    (with a window and even dims): one anchoring step at full resolution,
    none with skip_inv_warps; inv_coarse returns it at half resolution
    (the coarse carry; needs skip_inv_warps) and psi_inv0 may be half-res.
    """
    from sobfu_tpu_torch import pyramid

    dev = psi.device
    K = warp_window
    taps_t = torch.as_tensor(np.asarray(taps, np.float32), device=dev)
    alpha = float(np.float32(alpha))
    w_reg = float(np.float32(w_reg))
    thresh = float(np.float32(max_update_norm_thresh))
    n_step = int(inner_steps) if inner_steps and int(inner_steps) > 1 else 1
    if n_step > 1 and stall_window % n_step:
        raise ValueError(f"stall_window {stall_window} is not a multiple of inner_steps {n_step}")
    if n_step > 1 and record_energy and energy_cap < n_step:
        raise ValueError("record_energy with inner_steps needs energy_cap >= inner_steps")
    energy = torch.zeros(
        (energy_cap if record_energy else 1, 3), dtype=torch.float32, device=dev
    )

    def warp1(vol, at, floor=False):
        return kernels.warp(vol[None], at, K, (floor,))[0]

    tnp0 = warp1(tsdf_n, psi)
    if n_step > 1:
        # kernel E (kernels.GdMultiLoop): up to GD_MULTI_LAUNCHES chunks of
        # n_step iterations per host read, the stop test on the device; a
        # mid-chunk stop overshoots (the JAX fused_gd_multi_fold contract).
        # record_energy writes each chunk's rows: one chunk per read.
        loop = kernels.GdMultiLoop(psi, tnp0, tsdf_global, tsdf_n, taps_t, alpha, w_reg,
                                   momentum, K, thresh, max_iter, n_step, stall_window,
                                   stall_rel, verbose=record_energy)
        while loop.running:
            it0 = loop.count
            chunks = -(-(max_iter - it0) // n_step)
            _, rows = loop.run(1 if record_energy else min(kernels.GD_MULTI_LAUNCHES, chunks))
            if record_energy:
                row0 = max(0, min(it0, energy_cap - n_step))
                energy[row0:row0 + n_step] = rows
        psi, tsdf_n_psi = loop.state()[:2]
        it, mnorm = loop.count, loop.mnorm
    else:
        # kernel A: chunks of iterations with the norm test on the device
        # (kernels.GdLoop), so the count is the JAX while_loop's exactly; a
        # chunk ends at each stall check (decided here, in float32) and at
        # max_iter. record_energy reads the state before every iteration.
        loop = kernels.GdLoop("gd_iteration", psi[None], tnp0[None], tsdf_global[None],
                              tsdf_n[None], taps_t, alpha, w_reg, momentum, K, thresh,
                              energy=bool(stall_window))
        it, mnorm, e_ref, stalled = 0, float("inf"), float("inf"), False
        one = np.ones(1, bool)
        while it < max_iter and mnorm > thresh and not stalled:
            n = min(1 if record_energy else kernels.GD_CHUNK, max_iter - it)
            if stall_window:
                n = min(n, stall_window - it % stall_window)
            at_check = bool(stall_window) and (it + n) % stall_window == 0
            if record_energy:
                # pre-update energies beside the update norm (solver.py row layout)
                psi_s, tnp_s, _ = loop.state()
                pre = [data_energy(tsdf_global, tnp_s[0]), reg_energy_sobolev(psi_s[0])]
            done, rows, e = loop.run(n, one, with_energy=at_check)
            d = int(done[0])
            it += d
            mnorm = float(np.sqrt(rows[d - 1, 0]))
            if record_energy:
                energy[min(it - 1, energy_cap - 1)] = torch.stack(pre + [pre[0].new_tensor(mnorm)])
            if at_check and d == n:
                stalled, e_ref = stall_check(e[0], e_ref, it, stall_window, stall_rel)
        psi, tsdf_n_psi = (t[0] for t in loop.state()[:2])

    if skip_tails:
        return SolveResult(psi, psi, tsdf_n_psi, weight_n, tsdf_global, weight_global, it,
                           mnorm, energy)
    if inv_multigrid and K is not None and all(d % 2 == 0 for d in psi.shape[1:]):
        if inv_coarse and not skip_inv_warps:
            raise ValueError("inv_coarse carries a warm-start-only inverse: needs skip_inv_warps")
        psi_inv = pyramid.estimate_inverse_multigrid(
            psi, inverse_iters, K, init=psi_inv0, fine_iters=0 if skip_inv_warps else 1,
            return_coarse=inv_coarse,
        )
    else:
        psi_inv = kernels.inverse_fixed_point(psi, inverse_iters, K, init=psi_inv0)
    if skip_inv_warps:
        tsdf_g_inv, weight_g_inv = tsdf_global, weight_global
    else:
        both = kernels.warp(
            torch.stack([tsdf_global, weight_global]), psi_inv, K, (False, True)
        )
        tsdf_g_inv, weight_g_inv = both[0], both[1]
    weight_n_psi = weight_n if skip_weight_warp else warp1(weight_n, psi, floor=True)
    return SolveResult(
        psi=psi,
        psi_inv=psi_inv,
        tsdf_n_psi=tsdf_n_psi,
        weight_n_psi=weight_n_psi,
        tsdf_global_psi_inv=tsdf_g_inv,
        weight_global_psi_inv=weight_g_inv,
        iters=it,
        max_norm=mnorm,
        energy=energy,
    )


# ---------------------------------------------------------------------------
# coarse-to-fine pyramid solve
# ---------------------------------------------------------------------------

# iterations per kernel E launch on the coarse levels (sobfu_tpu/solver.py:1041)
COARSE_INNER_STEPS = 16
# level L stops at max_update_norm * COARSE_THRESH_SCALE**L (sobfu_tpu/solver.py:1016-1018)
COARSE_THRESH_SCALE = 0.5


def runs_gd_multi(dims_zyx, fused: bool) -> bool:
    """Where the JAX package runs ``fused_gd_multi_fold`` on a level: the
    fused path on a Y-foldable grid, X = 64, Y even, Z % 8 == 0
    (sobfu_tpu/solver.py:469-471, 1021-1041)."""
    Z, Y, X = dims_zyx
    return bool(fused) and X == 64 and Y % 2 == 0 and Z % 8 == 0


def estimate_psi_pyramid(
    psi: torch.Tensor,
    tsdf_global: torch.Tensor,
    weight_global: torch.Tensor,
    tsdf_n: torch.Tensor,
    weight_n: torch.Tensor,
    taps,
    alpha: float,
    w_reg: float,
    max_iter: int,
    max_update_norm_thresh: float,
    psi_inv0: Optional[torch.Tensor] = None,
    *,
    levels: int = 2,
    coarse_max_iter: Optional[int] = None,
    coarse_thresh_scale: float = COARSE_THRESH_SCALE,
    record_energy: bool = False,
    energy_cap: int = 0,
    inverse_iters: int = 48,
    warp_window: Optional[int] = None,
    momentum: Optional[float] = None,
    fused: bool = False,
    fine_window: Optional[int] = None,
    stall_window: int = 0,
    stall_rel: float = 1e-3,
    skip_inv_warps: bool = False,
    skip_weight_warp: bool = False,
    inv_multigrid: bool = False,
    inv_coarse: bool = False,
) -> SolveResult:
    """Coarse-to-fine wrapper around :func:`estimate_psi`
    (``sobfu_tpu.solver.estimate_psi_pyramid``).

    The coarse levels (:func:`_coarse_levels`) warm-start the fine level
    from the incoming displacement; only the fine level runs the inverse
    and the tail warps. ``iters`` counts every level's iterations
    (``coarse_iters`` the coarse share). coarse_max_iter caps each coarse
    level (None: max_iter); level L stops at max_update_norm_thresh *
    coarse_thresh_scale^L.

    fused: the accelerator dispatch (``Solver.fused``; JAX's fused_db). A
    coarse level where JAX would run ``fused_gd_multi_fold``
    (:func:`runs_gd_multi`) runs kernel E in chunks of 16 iterations with
    the chunked stop; every other level runs kernel A.

    fine_window: run the fine level as a compositive increment solve
    (:func:`estimate_psi_compositive`) in that window, with the tails, the
    T0 warp and the inverse bounded by ``warp_window`` (its total_window);
    skip_weight_warp does not apply there: kernel F returns the weight
    floor-warped.
    """
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    if inv_coarse and not inv_multigrid:
        raise ValueError("inv_coarse rides the multigrid inverse")
    ident_f = fields.identity_field(tuple(tsdf_n.shape), device=psi.device)
    disp, total_coarse = _coarse_levels(
        tsdf_global, tsdf_n, psi - ident_f, levels, taps, alpha, w_reg,
        max_iter if coarse_max_iter is None else coarse_max_iter,
        max_update_norm_thresh, warp_window=warp_window, momentum=momentum, fused=fused,
        thresh_scale=coarse_thresh_scale,
    )
    fine = dict(
        record_energy=record_energy,
        energy_cap=energy_cap,
        inverse_iters=inverse_iters,
        momentum=momentum,
        stall_window=stall_window,
        stall_rel=stall_rel,
        skip_inv_warps=skip_inv_warps,
        inv_multigrid=inv_multigrid,
        inv_coarse=inv_coarse,
    )
    args = (ident_f + disp, tsdf_global, weight_global, tsdf_n, weight_n, taps, alpha, w_reg,
            max_iter, max_update_norm_thresh, psi_inv0)
    if fine_window is not None:
        res = estimate_psi_compositive(
            *args, warp_window=fine_window, total_window=warp_window or 2, fused=fused, **fine
        )
    else:
        res = estimate_psi(
            *args, warp_window=warp_window, skip_weight_warp=skip_weight_warp, **fine
        )
    return res._replace(iters=res.iters + total_coarse, coarse_iters=total_coarse)


def _coarse_levels(tsdf_global, live, disp, levels, taps, alpha, w_reg, max_iter,
                   max_update_norm_thresh, *, warp_window, momentum, fused,
                   thresh_scale=COARSE_THRESH_SCALE):
    """The coarse levels of a pyramid: those of :func:`estimate_psi_pyramid`
    and the increment pyramid of :func:`estimate_psi_compositive`
    (sobfu_tpu/solver.py:1000-1065, 1705-1743).

    Level L runs on 2^L-downsampled TSDFs (the weights are never read by
    the loop, so only the TSDFs are pooled). disp, the incoming
    displacement at full resolution, is downsampled to the coarsest level
    (None: zero there); each level's result is upsampled with its
    displacement doubled to warm-start the next. A level stops at
    ``thresh * thresh_scale^L`` or after max_iter, with the metric-scaled window
    K_c = ceil(K / 2^L), no stall detector and no tails; where JAX would
    run ``fused_gd_multi_fold`` (:func:`runs_gd_multi`) it runs kernel E in
    chunks of 16 iterations. Returns (the full-resolution displacement that
    warm-starts the fine level, the coarse levels' iterations).
    """
    from sobfu_tpu_torch import pyramid

    pyr = [(tsdf_global, live)]
    for _ in range(levels - 1):
        tg_c, tn_c = pyr[-1]
        pyr.append((pyramid.downsample2(tg_c), pyramid.downsample2(tn_c)))
    dims_top = tuple(pyr[-1][0].shape)
    if disp is None:
        disp = torch.zeros((3,) + dims_top, dtype=torch.float32, device=live.device)
    elif levels > 1:
        disp = pyramid.resample_disp(disp, dims_top, 0.5 ** (levels - 1))

    total = 0
    for lev in range(levels - 1, 0, -1):
        tg_c, tn_c = pyr[lev]
        dims_c = tuple(tn_c.shape)
        ident_c = fields.identity_field(dims_c, device=live.device)
        thresh_c = float(
            np.float32(max_update_norm_thresh) * np.float32(thresh_scale ** lev)
        )
        K_c = max(1, -(-int(warp_window) // (2 ** lev))) if warp_window is not None else None
        res_c = estimate_psi(
            ident_c + disp, tg_c, tg_c, tn_c, tn_c, taps, alpha, w_reg, max_iter, thresh_c,
            skip_tails=True,
            warp_window=K_c,
            momentum=momentum,
            inner_steps=COARSE_INNER_STEPS if runs_gd_multi(dims_c, fused) else 0,
            # no stall detector on coarse levels: their data energy plateaus
            # early (sobfu_tpu/solver.py:1055-1059)
            stall_window=0,
        )
        total += res_c.iters
        disp = pyramid.resample_disp(res_c.psi - ident_c, pyr[lev - 1][0].shape, 2.0)
    return disp, total


# ---------------------------------------------------------------------------
# compositive mode
# ---------------------------------------------------------------------------

# the incremental inverse: window steps on the increment, then exact
# anchoring steps on the composed field (sobfu_tpu/solver.py:1498-1499)
INV_WINDOW_ITERS = 16
INV_REFINE_ITERS = 2


def estimate_psi_compositive(
    psi0: torch.Tensor,
    tsdf_global: torch.Tensor,
    weight_global: torch.Tensor,
    tsdf_n: torch.Tensor,
    weight_n: torch.Tensor,
    taps,
    alpha: float,
    w_reg: float,
    max_iter: int,
    max_update_norm_thresh: float,
    psi_inv0: Optional[torch.Tensor] = None,
    *,
    inverse_iters: int = 48,
    warp_window: int = 2,
    record_energy: bool = False,
    energy_cap: int = 0,
    momentum: Optional[float] = None,
    fused: bool = False,
    total_window: int = 0,
    stall_window: int = 0,
    stall_rel: float = 1e-3,
    skip_inv_warps: bool = False,
    inv_multigrid: bool = False,
    inner_steps: int = 0,
    inv_coarse: bool = False,
    pyramid_levels: int = 1,
    coarse_max_iter: Optional[int] = None,
    inv_window_iters: int = INV_WINDOW_ITERS,
    inv_refine_iters: int = INV_REFINE_ITERS,
) -> SolveResult:
    """Compositive-update solve (``sobfu_tpu.solver.estimate_psi_compositive``):
    psi = psi0 o (id + delta), so each iteration samples the pre-warped live
    volume T0 = phi_n o psi0 at id + delta, and only this frame's increment
    delta has to stay inside the window K = warp_window, however far psi0
    has drifted.

    The increment loop is :func:`estimate_psi` with ``skip_tails`` on the
    absolute state id + delta against live = T0: its Laplacian of
    id + delta is L(delta) up to the rounding of coordinates (an ulp of the
    largest coordinate per iteration), and kernel A or E runs it unchanged.
    The energy rows keep the increment convention (the regulariser of
    delta). pyramid_levels > 1: the increment pyramid, coarse levels from
    ZERO displacement against T0 downsampled (:func:`_coarse_levels`, each
    capped at coarse_max_iter, None: max_iter), the fine loop seeded from
    id + their displacement.

    total_window: the total deformation is known to stay within it (the
    fine level of a pyramid): T0 is sampled in that window, kernel F
    composes psi_new = psi0 o g in the window K and floor-samples weight_n
    at psi_new in the total window, the inverse runs in the total window
    (the multigrid one when inv_multigrid and fused on even dims; inv_coarse
    returns it half-res) from psi_inv0, and the tails sample in the total
    window. 0: T0 and the weight are exact samples, the composition is the
    window-K field sample (kernel B, C=3) when fused and the exact one
    otherwise, the inverse is incremental from psi_inv0 (C on the increment
    in the window K, one exact sample of its displacement at psi_inv0,
    INV_REFINE_ITERS exact anchoring steps) or cold and exact without it,
    and the tails are exact; skip_inv_warps skips the inverse too (JAX's
    skip_inverse, which the frame loop always sets with it): psi_inv passes
    through as psi_inv0 (psi0 without it).
    """
    from sobfu_tpu_torch import pyramid

    if inv_coarse and not (inv_multigrid and skip_inv_warps and fused):
        raise ValueError(
            "inv_coarse carries a warm-start-only multigrid inverse: needs inv_multigrid, "
            "skip_inv_warps and fused"
        )
    dims = tuple(tsdf_n.shape)
    ident = fields.identity_field(dims, device=psi0.device)
    K = int(warp_window)
    t0 = kernels.warp(tsdf_n[None], psi0, total_window or None, (False,))[0]
    g0, total_coarse = ident, 0
    if pyramid_levels > 1:
        disp, total_coarse = _coarse_levels(
            tsdf_global, t0, None, pyramid_levels, taps, alpha, w_reg,
            max_iter if coarse_max_iter is None else coarse_max_iter, max_update_norm_thresh, warp_window=K, momentum=momentum, fused=fused,
        )
        g0 = ident + disp
    # the loop's first warp seeds tnp: B at K on T0 (T0 itself at the identity)
    loop = estimate_psi(
        g0, tsdf_global, weight_global, t0, weight_n, taps, alpha, w_reg, max_iter,
        max_update_norm_thresh,
        record_energy=record_energy,
        energy_cap=energy_cap,
        warp_window=K,
        momentum=momentum,
        stall_window=stall_window,
        stall_rel=stall_rel,
        skip_tails=True,
        inner_steps=inner_steps if runs_gd_multi(dims, fused) else 0,
    )
    g = loop.psi  # the absolute id + delta

    def tails(psi_inv, K_tail):
        both = kernels.warp(torch.stack([tsdf_global, weight_global]), psi_inv, K_tail,
                            (False, True))
        return both[0], both[1]

    tails_skipped = (tsdf_global, weight_global)
    if total_window:
        psi_new, weight_n_psi = kernels.compose_weight(psi0, g, weight_n, K, total_window)
        if inv_multigrid and fused and all(d % 2 == 0 for d in dims):
            psi_inv = pyramid.estimate_inverse_multigrid(
                psi_new, inverse_iters, total_window, init=psi_inv0,
                fine_iters=0 if skip_inv_warps else 1, return_coarse=inv_coarse,
            )
        else:
            psi_inv = kernels.inverse_fixed_point(psi_new, inverse_iters, total_window,
                                                  init=psi_inv0)
        g_inv = tails_skipped if skip_inv_warps else tails(psi_inv, total_window)
    else:
        psi_new = kernels.warp_field3(psi0, g, K if fused else None)
        if skip_inv_warps:
            psi_inv = psi_inv0 if psi_inv0 is not None else psi0
        elif psi_inv0 is None:
            psi_inv = kernels.inverse_fixed_point(psi_new, inverse_iters, None)
        else:
            # psi_new^-1 = g^-1 o psi0^-1: g is window-bounded, so its inverse
            # runs in the window; dq = id - g^-1 is sampled at psi_inv0
            dq = ident - kernels.inverse_fixed_point(g, inv_window_iters, K)
            psi_inv = psi_inv0 - kernels.warp_field3(dq, psi_inv0, None)
            if inv_refine_iters:
                psi_inv = kernels.inverse_fixed_point(psi_new, inv_refine_iters, None,
                                                      init=psi_inv)
        g_inv = tails_skipped if skip_inv_warps else tails(psi_inv, None)
        weight_n_psi = kernels.warp(weight_n[None], psi_new, None, (True,))[0]
    return SolveResult(
        psi=psi_new,
        psi_inv=psi_inv,
        tsdf_n_psi=loop.tsdf_n_psi,
        weight_n_psi=weight_n_psi,
        tsdf_global_psi_inv=g_inv[0],
        weight_global_psi_inv=g_inv[1],
        iters=loop.iters + total_coarse,
        max_norm=loop.max_norm,
        energy=loop.energy,
        coarse_iters=total_coarse,
    )


def production_pyramid_kwargs(dim: int, *, warm: bool = True, no_log: bool = True) -> dict:
    """The production configuration of :func:`estimate_psi_pyramid` on a
    cubic grid of extent ``dim`` (``sobfu_tpu.solver.production_pyramid_
    kwargs`` without its TPU layout keys fused_db, conv_mxu and fold_xmats;
    ``fused`` is the port's dispatch flag in fused_db's place).

    warm: per-frame steady state (previous-frame inverse, 3 fixed-point
    steps); False = a cold single solve (48 steps). no_log: the no-log
    loop, where psi_inv is a warm-start-only product (skip_inv_warps, and
    the half-resolution inverse carry when warm).
    """
    multigrid = dim % 2 == 0 and dim >= 64
    return dict(
        levels=3 if dim >= 256 else 2,
        warp_window=2,
        momentum=0.95,
        fine_window=None,
        stall_window=16,
        stall_rel=1e-2,
        fused=True,
        inverse_iters=3 if warm else 48,
        skip_inv_warps=no_log,
        inv_multigrid=multigrid,
        inv_coarse=bool(warm and no_log and multigrid),
    )


# ---------------------------------------------------------------------------
# host-facing Solver (parity with sobfu::cuda::Solver, solver.hpp:56-94)
# ---------------------------------------------------------------------------


class Solver:
    """Reads the solver keys of ``params`` and derives the solve's options
    the way ``sobfu_tpu.solver.Solver`` does on an accelerator.

    JAX derives its dispatch from ``fused_pallas``, whose automatic rule
    holds only off the CPU. The port takes the accelerator's rule whatever
    its device, so the derivations never depend on ``torch.device``:
    ``fused`` (FUSED_PALLAS, else auto) is on when WARP_WINDOW is 1..4, the
    filter has at most 7 taps and X >= 64 (the platform test and the Mosaic
    tiling tests are left out). From it, as in JAX: PYRAMID_LEVELS (dropped
    to 1 when the dims do not halve evenly), INV_MULTIGRID (auto: fused with
    a pyramid), INNER_STEPS (kept only on a fused X=64 grid with MAX_ITER
    and STALL_WINDOW multiples of it), INV_COARSE (an attribute, no .ini
    key: on with INV_MULTIGRID and fused) and INVERSE_ITERS. Tests that
    compare with JAX on the CPU pass FUSED_PALLAS explicitly to both.
    SOLVER_MODE (``mode``), INCREMENTAL_INV (``incremental_inverse``, None =
    on) and FINE_WINDOW are read as JAX reads them. USE_PALLAS, WARP_PALLAS,
    Z_CHUNKS, CONV_MXU and FOLD_XMATS select TPU layouts and have no effect
    here.
    """

    def __init__(self, params: Params):
        self.params = params
        self.taps = sobolev_filter_1d(params.s, params.lambda_)
        self.verbosity = params.verbosity
        self.mode = getattr(params, "solver_mode", "additive")
        if self.mode not in ("additive", "compositive"):
            raise ValueError(f"SOLVER_MODE must be additive or compositive, got {self.mode}")
        inc_inv = getattr(params, "incremental_inverse", None)
        self.incremental_inverse = True if inc_inv is None else bool(inc_inv)
        self.warp_window = getattr(params, "warp_window", None)
        self.pyramid_levels = int(getattr(params, "pyramid_levels", 1) or 1)
        if self.pyramid_levels > 1:
            f = 2 ** (self.pyramid_levels - 1)
            if any(d % f for d in params.volume_dims):
                self.pyramid_levels = 1  # dims don't halve evenly
        X, Y, Z = params.volume_dims  # volume_dims is (X, Y, Z)
        fused = getattr(params, "fused_pallas", None)
        if fused is None:
            ww = self.warp_window
            fused = ww is not None and 1 <= int(ww) <= 4 and len(self.taps) <= 7 and X >= 64
        self.fused = bool(fused)
        if self.fused and self.warp_window is None:
            # the fused path is window-based: the production default K=2
            self.warp_window = 2
        self.momentum = getattr(params, "momentum", None)
        self.stall_window = int(getattr(params, "stall_window", 0) or 0)
        self.stall_rel = float(getattr(params, "stall_rel", 1e-3))
        self.fine_window = getattr(params, "fine_window", None)
        img = getattr(params, "inv_multigrid", None)
        self.inv_multigrid = (
            self.fused and (self.fine_window is not None or self.pyramid_levels > 1)
            if img is None
            else bool(img)
        )
        inner = int(getattr(params, "inner_steps", 0) or 0)
        if inner > 1 and (
            not runs_gd_multi((Z, Y, X), self.fused)
            or (self.stall_window and self.stall_window % inner)
            or params.max_iter % inner
        ):
            inner = 0
        self.inner_steps = inner
        warm = getattr(params, "inverse_warm", None)
        self.inverse_warm = self.warp_window is not None if warm is None else bool(warm)
        self.inv_coarse = bool(
            getattr(params, "inv_coarse", None) and self.inv_multigrid and self.fused
        )
        inv_iters = getattr(params, "inverse_iters", None)
        if inv_iters is None:
            inv_iters = 3 if self.inverse_warm else 48
        self.inverse_iters = int(inv_iters)

    def solve_kwargs(self) -> dict:
        """The options every solve of this Solver shares."""
        return dict(
            inverse_iters=self.inverse_iters,
            warp_window=self.warp_window,
            momentum=self.momentum,
            stall_window=self.stall_window,
            stall_rel=self.stall_rel,
        )

    @property
    def takes_psi_inv0(self) -> bool:
        """Whether a solve starts from the previous frame's psi_inv:
        incremental_inverse in compositive mode, inverse_warm otherwise
        (sobfu_tpu/pipeline.py:414-420)."""
        return self.incremental_inverse if self.mode == "compositive" else self.inverse_warm

    def solve(self, psi, tsdf_global, weight_global, tsdf_n, weight_n, psi_inv0=None, *,
              record_energy: bool = False, skip_inv_warps: bool = False,
              skip_weight_warp: bool = False, inv_coarse: bool = False) -> SolveResult:
        """One frame's solve on tensors, dispatched as JAX's
        ``Solver.estimate_psi`` and ``fused_frame_step`` dispatch it: compositive
        mode (the increment pyramid when PYRAMID_LEVELS > 1; skip_inv_warps
        skips the inverse too, and skip_weight_warp and inv_coarse do not
        apply), else the pyramid when PYRAMID_LEVELS > 1 (its fine level
        compositive with FINE_WINDOW), else the single-level solve (with
        INNER_STEPS chunks where kept)."""
        p = self.params
        args = (psi, tsdf_global, weight_global, tsdf_n, weight_n, self.taps, p.alpha,
                p.w_reg, p.max_iter, p.max_update_norm, psi_inv0)
        kw = dict(
            record_energy=record_energy,
            energy_cap=p.max_iter if record_energy else 0,
            skip_inv_warps=skip_inv_warps,
            **self.solve_kwargs(),
        )
        if self.mode == "compositive":
            # JAX leaves inverse_iters at its default (48) in this mode
            kw.pop("inverse_iters")
            kw["warp_window"] = self.warp_window or 2
            return estimate_psi_compositive(
                *args, fused=self.fused, inner_steps=self.inner_steps,
                pyramid_levels=self.pyramid_levels, **kw,
            )
        kw["skip_weight_warp"] = skip_weight_warp
        if self.pyramid_levels > 1:
            return estimate_psi_pyramid(
                *args, levels=self.pyramid_levels, fused=self.fused,
                fine_window=self.fine_window, inv_multigrid=self.inv_multigrid,
                inv_coarse=inv_coarse, **kw,
            )
        return estimate_psi(*args, inner_steps=self.inner_steps, **kw)

    def estimate_psi(self, phi_global, phi_global_psi_inv, phi_n, phi_n_psi,
                     psi, psi_inv) -> SolveResult:
        """Run the solve; updates the passed volume/field wrappers in place
        (reference sob_fusion.cpp:141 -> solver.cpp:69-101)."""
        p = self.params
        res = self.solve(
            psi.data, phi_global.tsdf, phi_global.weight, phi_n.tsdf, phi_n.weight,
            psi_inv.data if self.takes_psi_inv0 else None,
            record_energy=self.verbosity > 0,
        )
        psi.data = res.psi
        psi_inv.data = res.psi_inv
        phi_n_psi.tsdf = res.tsdf_n_psi
        phi_n_psi.weight = res.weight_n_psi
        phi_global_psi_inv.tsdf = res.tsdf_global_psi_inv
        phi_global_psi_inv.weight = res.weight_global_psi_inv

        if self.verbosity > 0:
            iters = int(res.iters)
            hist = res.energy.cpu().numpy()
            stride = 1 if self.verbosity >= 2 else 50
            # valid rows carry a positive max-update norm (only the fine
            # level's rows are recorded; iters counts the coarse levels too)
            nz = np.flatnonzero(hist[:, 2] > 0)
            n_valid = int(nz[-1]) + 1 if nz.size else 0
            for i in range(0, min(iters, n_valid), stride):
                e_data, e_reg, mnorm = hist[i]
                print(
                    f"iter. no. {i + 1}: data energy + w_reg * reg energy = "
                    f"{e_data:.6f} + {p.w_reg} * {e_reg:.6f} = "
                    f"{e_data + p.w_reg * e_reg:.6f}; max. update norm {mnorm:.3e}"
                )
            if float(res.max_norm) <= p.max_update_norm:
                print(f"SOLVER CONVERGED AFTER {iters} ITERATIONS")
            elif self.stall_window and iters < p.max_iter * max(1, self.pyramid_levels):
                print(
                    f"SOLVER STOPPED ON DATA-ENERGY STALL AFTER {iters} "
                    "ITERATIONS (update norm still above threshold)"
                )
            else:
                print("SOLVER REACHED MAX. NO. OF ITERATIONS WITHOUT CONVERGING")
        return res
