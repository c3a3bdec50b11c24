"""The SobFusion pipeline: depth stream -> deforming TSDF reconstruction.

PyTorch counterpart of ``sobfu_tpu.pipeline`` (reference
src/sobfu/sob_fusion.cpp):

  frame 0:   bilateral filter -> depth truncation -> dists ->
             integrate into phi_global; allocate phi_*, psi, psi_inv, solver
  frame n:   if n < start_frame: integrate phi_n and fuse it rigidly
             else :func:`fused_frame_step`: integrate phi_n, estimate psi
             (Sobolev GD), fuse phi_n o psi into phi_global

All state lives on the device given to :class:`SobFusion`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sobfu_tpu_torch import core, fields, pyramid
from sobfu_tpu_torch import solver as solver_mod
from sobfu_tpu_torch.config import Params
from sobfu_tpu_torch.fields import DeformationField
from sobfu_tpu_torch.ops import frontend, kernels
from sobfu_tpu_torch.tsdf import TsdfVolume, fuse_volumes, fuse_volumes_gated, integrate_dists


def preprocess(depth: torch.Tensor, p: Params) -> torch.Tensor:
    """Bilateral filter -> depth truncation -> dists (metres): kernel P on the
    card, its plain version on the CPU (``frontend.preprocess_depth``)."""
    return frontend.preprocess_depth(
        depth, p.bilateral_kernel_size, p.bilateral_sigma_spatial, p.bilateral_sigma_depth,
        p.icp_truncate_depth_dist, p.intr,
    )


def fused_frame_step(
    depth: torch.Tensor,
    phi_global: TsdfVolume,
    psi: torch.Tensor,
    solver: solver_mod.Solver,
    vol2cam: np.ndarray,
    psi_inv0: Optional[torch.Tensor] = None,
    *,
    skip_inv_warps: bool = False,
    skip_weight_warp: bool = False,
):
    """One complete non-rigid frame (``sobfu_tpu.pipeline.fused_frame_step``):
    preprocess -> integrate phi_n -> solve (Solver.solve: the compositive
    mode, the pyramid when PYRAMID_LEVELS > 1, else one level) -> fuse.

    skip_weight_warp: the additive solve returns weight_n unwarped and the
    fuse runs as the warp_fuse kernel, which floor-warps it at psi itself
    (the no-log loop). The port applies the exact rule when no window is
    set. With skip_inv_warps, Solver.inv_coarse carries psi_inv at half
    resolution; in compositive mode skip_inv_warps also skips the inverse.

    Returns (tsdf_g', weight_g', tsdf_n, weight_n, SolveResult).
    """
    p = solver.params
    dists = preprocess(depth, p)
    zeros = torch.zeros(phi_global.dims_zyx, dtype=torch.float32, device=depth.device)
    tn, wn = integrate_dists(
        zeros, zeros, dists, vol2cam, p.intr, phi_global.voxel_sizes(),
        phi_global.trunc_dist, phi_global.eta,
        axis_aligned=bool(np.allclose(vol2cam[:3, :3], np.eye(3), atol=1e-6)),
    )
    tg, wg = phi_global.tsdf, phi_global.weight
    res = solver.solve(
        psi, tg, wg, tn, wn, psi_inv0,
        skip_inv_warps=skip_inv_warps,
        skip_weight_warp=skip_weight_warp,
        inv_coarse=solver.inv_coarse and skip_inv_warps,
    )
    K = solver.warp_window
    gate = float(getattr(p, "new_surface_gate", 0.0) or 0.0)
    if gate > 0:
        # surface-confidence gate on new canonical surface
        wnp = res.weight_n_psi
        if skip_weight_warp:
            wnp = kernels.warp(wn[None], res.psi, K, (True,))[0]
            res = res._replace(weight_n_psi=wnp)
        disp_norm = torch.amax(torch.abs(fields.displacement(res.psi)), dim=0)
        tg2, wg2 = fuse_volumes_gated(
            tg, wg, res.tsdf_n_psi, wnp, phi_global.max_weight, disp_norm, gate
        )
    elif skip_weight_warp:
        tg2, wg2 = kernels.warp_fuse(
            tg, wg, res.tsdf_n_psi, wn, res.psi, phi_global.max_weight, K
        )
    else:
        tg2, wg2 = fuse_volumes(
            tg, wg, res.tsdf_n_psi, res.weight_n_psi, phi_global.max_weight
        )
    return tg2, wg2, tn, wn, res


class SobFusion:
    """Stateful frame loop (reference include/sobfu/sob_fusion.hpp:21-74).

    device: where every volume and field lives ("cuda" or "cpu"); "cuda"
    without a card raises.
    """

    def __init__(self, params: Params, device="cuda"):
        self.params = params
        self.device = core.resolve_device(device)
        self.frame_counter = 0
        self.poses = [np.eye(4, dtype=np.float32)]
        # phi_global o psi_inv and phi_n_psi.weight are per-frame products
        # with no consumer in the no-log loop (the CLI clears this without
        # --enable-log); the mesh getters refresh them on demand
        self.need_inv_warps = True
        self._inv_warps_stale = False
        self._n_psi_weight_stale = False

        self.phi_global: Optional[TsdfVolume] = None
        self.phi_global_psi_inv: Optional[TsdfVolume] = None
        self.phi_n: Optional[TsdfVolume] = None
        self.phi_n_psi: Optional[TsdfVolume] = None
        self.psi: Optional[DeformationField] = None
        self.psi_inv: Optional[DeformationField] = None
        self.solver: Optional[solver_mod.Solver] = None
        self.last_solve = None

    def _coarse_inv_carry(self) -> bool:
        """True when the frame loop carries psi_inv at HALF resolution: the
        no-log loop with Solver.inv_coarse on a pyramid over even dims
        (``sobfu_tpu.pipeline.SobFusion._coarse_inv_carry``)."""
        s, p = self.solver, self.params
        return bool(
            s.inv_coarse
            and s.inverse_warm
            and not self.need_inv_warps
            and p.verbosity == 0
            and s.mode == "additive"
            and s.pyramid_levels > 1
            and all(d % 2 == 0 for d in p.volume_dims)
        )

    def _skip_weight_warp(self) -> bool:
        """True when the no-log frame step leaves weight_n's floor warp to
        the fuse: the additive mode only (sobfu_tpu/pipeline.py:390-397).
        A compositive fine level (FINE_WINDOW with a pyramid) returns the
        weight already floor-warped by kernel F, so the port fuses with it
        instead of warping it a second time as JAX does."""
        s = self.solver
        return bool(
            not self.need_inv_warps
            and s.mode == "additive"
            and not (s.pyramid_levels > 1 and s.fine_window is not None)
        )

    def _depth_tensor(self, depth) -> torch.Tensor:
        d = torch.as_tensor(np.asarray(depth).astype(np.int32)) if not isinstance(
            depth, torch.Tensor
        ) else depth.to(torch.int32)
        return d.to(self.device)

    # -- per-frame entry (reference sob_fusion.cpp:71-145) -------------------
    def __call__(self, depth, image=None) -> bool:
        """Process one depth frame (mm; numpy uint16 or a torch tensor).
        image, the colour frame, is accepted and unused, as in
        ``sobfu_tpu.pipeline.SobFusion.__call__``."""
        p = self.params
        if p.verbosity > 0:
            print(f"--- FRAME NO. {self.frame_counter} ---")
        depth = self._depth_tensor(depth)

        if self.frame_counter == 0:
            self.solver = solver_mod.Solver(p)
            self.phi_global = TsdfVolume(p, self.device)
            self.phi_global.integrate(preprocess(depth, p), self.poses[-1], p.intr)
            self.phi_global_psi_inv = TsdfVolume(p, self.device)
            self.phi_n = TsdfVolume(p, self.device)
            self.phi_n_psi = TsdfVolume(p, self.device)
            self.psi = DeformationField(p.volume_dims, device=self.device)
            # psi_inv at its carry resolution: with the half-res inverse
            # carry the solve returns it half-res from frame 1 on
            # (sobfu_tpu/pipeline.py:342-352)
            inv_dims = p.volume_dims
            if self._coarse_inv_carry():
                inv_dims = tuple(d // 2 for d in p.volume_dims)
            self.psi_inv = DeformationField(inv_dims, device=self.device)
            self.frame_counter += 1
            return True

        if self.frame_counter < p.start_frame:
            self.phi_n.clear()
            self.phi_n.integrate(preprocess(depth, p), self.poses[-1], p.intr)
            self.phi_global.integrate_volume(self.phi_n)
            self.frame_counter += 1
            return True

        psi_inv0 = self.psi_inv.data if self.solver.takes_psi_inv0 else None
        if p.verbosity == 0:
            vol2cam = (
                np.linalg.inv(np.asarray(self.poses[-1], np.float32))
                @ self.phi_global.pose
            )
            skip_weight_warp = self._skip_weight_warp()
            tg2, wg2, tn, wn, res = fused_frame_step(
                depth, self.phi_global, self.psi.data, self.solver, vol2cam, psi_inv0,
                skip_inv_warps=not self.need_inv_warps,
                skip_weight_warp=skip_weight_warp,
            )
            self.phi_n.tsdf, self.phi_n.weight = tn, wn
            self.psi.data = res.psi
            self.psi_inv.data = res.psi_inv
            self.phi_n_psi.tsdf = res.tsdf_n_psi
            self.phi_n_psi.weight = res.weight_n_psi
            self._n_psi_weight_stale = bool(
                skip_weight_warp and not getattr(p, "new_surface_gate", 0.0)
            )
            if self.need_inv_warps:
                self.phi_global_psi_inv.tsdf = res.tsdf_global_psi_inv
                self.phi_global_psi_inv.weight = res.weight_global_psi_inv
            else:
                self._inv_warps_stale = True
            self.phi_global.tsdf, self.phi_global.weight = tg2, wg2
            self.last_solve = res
        else:
            # staged path: the solver records and prints per-iteration energies
            self.phi_n.clear()
            self.phi_n.integrate(preprocess(depth, p), self.poses[-1], p.intr)
            self.last_solve = self.solver.estimate_psi(
                self.phi_global, self.phi_global_psi_inv, self.phi_n, self.phi_n_psi,
                self.psi, self.psi_inv,
            )
            gate = float(getattr(p, "new_surface_gate", 0.0) or 0.0)
            if gate > 0:
                disp_norm = torch.amax(torch.abs(fields.displacement(self.psi.data)), dim=0)
                self.phi_global.tsdf, self.phi_global.weight = fuse_volumes_gated(
                    self.phi_global.tsdf, self.phi_global.weight,
                    self.phi_n_psi.tsdf, self.phi_n_psi.weight,
                    self.phi_global.max_weight, disp_norm, gate,
                )
            else:
                self.phi_global.integrate_volume(self.phi_n_psi)

        self.frame_counter += 1
        return True

    # -- mesh getters (reference sob_fusion.cpp:43-49, 147-158) --------------
    def _get_mesh(self, vol: TsdfVolume):
        from sobfu_tpu_torch import mc

        return mc.extract_mesh(vol.tsdf, vol.weight, vol.voxel_sizes(), pose=vol.pose)

    def get_phi_global_mesh(self):
        return self._get_mesh(self.phi_global)

    def full_res_inverse(self) -> torch.Tensor:
        """psi_inv at full resolution. A half-res carry (Solver.inv_coarse)
        is upsampled and anchored with one full-res fixed-point step against
        the current psi, the step estimate_inverse_multigrid's fine_iters=1
        runs (sobfu_tpu/pipeline.py:543-557); the carry itself stays
        half-res for the next frame's warm start."""
        inv = self.psi_inv.data
        dims = self.phi_global.dims_zyx
        if tuple(inv.shape[1:]) == tuple(dims):
            return inv
        q0 = pyramid.upsample_inverse(inv, dims)
        return kernels.inverse_fixed_point(
            self.psi.data, 1, self.solver.warp_window or 2, q0.contiguous()
        )

    def _refresh_inv_warps(self):
        """Recompute phi_global o psi_inv on demand (skipped in the frame
        step when no per-frame consumer exists — see need_inv_warps).

        Compositive mode: the no-log loop keeps no inverse and psi may have
        drifted past any window, so psi_inv becomes the exact cold 48-step
        inverse and the warps are exact (sobfu_tpu/pipeline.py:529-542)."""
        stack = torch.stack([self.phi_global.tsdf, self.phi_global.weight])
        if self.solver.mode == "compositive":
            self.psi_inv.data = kernels.inverse_fixed_point(self.psi.data, 48, None)
            both = kernels.warp(stack, self.psi_inv.data, None, (False, True))
        else:
            both = kernels.warp(
                stack, self.full_res_inverse(), self.solver.warp_window, (False, True)
            )
        self.phi_global_psi_inv.tsdf, self.phi_global_psi_inv.weight = both[0], both[1]
        self._inv_warps_stale = False

    def get_phi_global_psi_inv_mesh(self):
        if self._inv_warps_stale:
            self._refresh_inv_warps()
        return self._get_mesh(self.phi_global_psi_inv)

    def get_phi_n_mesh(self):
        return self._get_mesh(self.phi_n)

    def _refresh_n_psi_weight(self):
        """Recompute phi_n_psi.weight on demand: the warp_fuse kernel warps
        weight_n in place of a standalone warped copy."""
        self.phi_n_psi.weight = kernels.warp(
            self.phi_n.weight[None], self.psi.data, self.solver.warp_window, (True,)
        )[0]
        self._n_psi_weight_stale = False

    def get_phi_n_psi_mesh(self):
        if self._n_psi_weight_stale:
            self._refresh_n_psi_weight()
        return self._get_mesh(self.phi_n_psi)

    def get_deformation_field(self) -> DeformationField:
        return self.psi
