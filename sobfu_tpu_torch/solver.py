"""Sobolev-gradient warp-field solver (additive, reference path).

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
norm on the host after every iteration, which keeps the reference's exact
stopping semantics (the same ``iters`` as JAX).
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


class SolverState(NamedTuple):
    psi: torch.Tensor          # f32[3,Z,Y,X] absolute coords (voxel units)
    tsdf_n_psi: torch.Tensor   # f32[Z,Y,X]   warped live tsdf
    iter: int                  # iterations completed
    max_norm: float            # last max-update norm
    energy: torch.Tensor       # f32[cap, 3]  (e_data, e_reg, max_norm) history
    vel: Optional[torch.Tensor]  # heavy-ball velocity (None without momentum)
    e_ref: float = float("inf")
    stalled: bool = False


class SolveResult(NamedTuple):
    psi: torch.Tensor
    psi_inv: torch.Tensor
    tsdf_n_psi: torch.Tensor
    weight_n_psi: torch.Tensor
    tsdf_global_psi_inv: torch.Tensor
    weight_global_psi_inv: torch.Tensor
    iters: int
    max_norm: float
    energy: torch.Tensor


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
    skip_inv_warps: bool = False,
    skip_weight_warp: bool = False,
) -> SolveResult:
    """The full warp-field solve for one frame (``sobfu_tpu.solver.
    estimate_psi``, additive reference path).

    warp_window: K of the window sampler for every warp, iteration and
    inverse; None = exact sampler. psi_inv0 warm-starts the inverse fixed
    point (None = identity). momentum: heavy-ball coefficient (None = plain
    GD). record_energy: per-iteration rows (pre-update data energy,
    pre-update reg energy, update norm). stall_window / stall_rel: the
    data-energy stall stop (0 = off). skip_inv_warps: return pass-throughs
    for phi_global o psi_inv (the no-log loop). skip_weight_warp: return the
    unwarped weight_n (the caller fuses with the warp_fuse kernel).
    """
    dev = psi.device
    K = warp_window
    taps_t = torch.as_tensor(np.asarray(taps, np.float32), device=dev)
    alpha = float(np.float32(alpha))
    w_reg = float(np.float32(w_reg))
    thresh = float(np.float32(max_update_norm_thresh))
    energy = torch.zeros(
        (energy_cap if record_energy else 1, 3), dtype=torch.float32, device=dev
    )

    def warp1(vol, at, floor=False):
        return kernels.warp(vol[None], at, K, (floor,))[0]

    def gd_step(state: SolverState) -> SolverState:
        psi, tsdf_n_psi = state.psi, state.tsdf_n_psi
        psi_new, tsdf_new, vel_new, max_sq = kernels.gd_iteration(
            psi, tsdf_n_psi, state.vel, tsdf_global, tsdf_n, taps_t, alpha, w_reg,
            momentum, K,
        )
        mnorm = torch.sqrt(max_sq)
        if record_energy:
            # pre-update energies beside the update norm (solver.py row layout)
            state.energy[min(state.iter, energy_cap - 1)] = torch.stack(
                [data_energy(tsdf_global, tsdf_n_psi), reg_energy_sobolev(psi), mnorm]
            )
        it1 = state.iter + 1
        e_ref, stalled = state.e_ref, state.stalled
        if stall_window:
            e_now = np.float32(float(data_energy(tsdf_global, tsdf_new)))
            at_check = it1 % stall_window == 0
            stalled = stalled or (
                at_check
                and it1 >= 2 * stall_window
                and np.float32(e_ref) - e_now < np.float32(stall_rel) * abs(e_now)
            )
            if at_check:
                e_ref = float(e_now)
        return SolverState(
            psi_new, tsdf_new, it1, float(mnorm), state.energy, vel_new, e_ref, stalled
        )

    # the stop test reads the max norm on the host after every iteration:
    # the same iteration count as the JAX while_loop's predicate
    state = SolverState(
        psi, warp1(tsdf_n, psi), 0, float("inf"), energy,
        torch.zeros_like(psi) if momentum is not None else None,
    )
    while state.iter < max_iter and state.max_norm > thresh and not state.stalled:
        state = gd_step(state)
    psi, tsdf_n_psi, it, mnorm = state.psi, state.tsdf_n_psi, state.iter, state.max_norm

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
# host-facing Solver (parity with sobfu::cuda::Solver, solver.hpp:56-94)
# ---------------------------------------------------------------------------

# keys the port does not run yet, with the ROADMAP item that brings them
_NOT_PORTED = "not ported to sobfu_tpu_torch yet (ROADMAP.md, {})"


class Solver:
    """Reads the solver keys of ``params`` the way ``sobfu_tpu.solver.Solver``
    does on its non-fused path. USE_PALLAS, WARP_PALLAS, Z_CHUNKS, CONV_MXU
    and FOLD_XMATS select TPU layouts and have no effect here."""

    def __init__(self, params: Params):
        self.params = params
        self.taps = sobolev_filter_1d(params.s, params.lambda_)
        self.verbosity = params.verbosity
        self.mode = getattr(params, "solver_mode", "additive")
        if self.mode != "additive":
            raise NotImplementedError(
                "SOLVER_MODE=compositive " + _NOT_PORTED.format("Next, item 2")
            )
        if int(getattr(params, "pyramid_levels", 1) or 1) > 1:
            raise NotImplementedError(
                "PYRAMID_LEVELS>1 " + _NOT_PORTED.format("Next, item 1")
            )
        if int(getattr(params, "inner_steps", 0) or 0) > 1:
            raise NotImplementedError(
                "INNER_STEPS " + _NOT_PORTED.format("Next, item 3")
            )
        if getattr(params, "inv_multigrid", None):
            raise NotImplementedError(
                "INV_MULTIGRID " + _NOT_PORTED.format("Next, item 1")
            )
        if getattr(params, "inv_coarse", None):
            raise NotImplementedError(
                "INV_COARSE " + _NOT_PORTED.format("Next, item 1")
            )
        self.warp_window = getattr(params, "warp_window", None)
        if self.warp_window is None and getattr(params, "fused_pallas", None):
            # FUSED_PALLAS=1 without WARP_WINDOW: the JAX package's fused
            # kernel is window-based and takes the production default K=2
            self.warp_window = 2
        self.momentum = getattr(params, "momentum", None)
        self.stall_window = int(getattr(params, "stall_window", 0) or 0)
        self.stall_rel = float(getattr(params, "stall_rel", 1e-3))
        warm = getattr(params, "inverse_warm", None)
        self.inverse_warm = self.warp_window is not None if warm is None else bool(warm)
        inv_iters = getattr(params, "inverse_iters", None)
        if inv_iters is None:
            inv_iters = 3 if self.inverse_warm else 48
        self.inverse_iters = int(inv_iters)

    def solve_kwargs(self) -> dict:
        return dict(
            inverse_iters=self.inverse_iters,
            warp_window=self.warp_window,
            momentum=self.momentum,
            stall_window=self.stall_window,
            stall_rel=self.stall_rel,
        )

    def estimate_psi(self, phi_global, phi_global_psi_inv, phi_n, phi_n_psi,
                     psi, psi_inv) -> SolveResult:
        """Run the solve; updates the passed volume/field wrappers in place
        (reference sob_fusion.cpp:141 -> solver.cpp:69-101)."""
        p = self.params
        record = self.verbosity > 0
        res = estimate_psi(
            psi.data, phi_global.tsdf, phi_global.weight, phi_n.tsdf, phi_n.weight,
            self.taps, p.alpha, p.w_reg, p.max_iter, p.max_update_norm,
            psi_inv.data if self.inverse_warm else None,
            record_energy=record,
            energy_cap=p.max_iter if record else 0,
            **self.solve_kwargs(),
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
            elif self.stall_window and iters < p.max_iter:
                print(
                    f"SOLVER STOPPED ON DATA-ENERGY STALL AFTER {iters} "
                    "ITERATIONS (update norm still above threshold)"
                )
            else:
                print("SOLVER REACHED MAX. NO. OF ITERATIONS WITHOUT CONVERGING")
        return res
