"""Energy / convergence reductions over the voxel grid.

PyTorch counterpart of ``sobfu_tpu.reductor`` (reference
``sobfu::device::Reductor``, include/sobfu/reductor.hpp:24-75): the
object-style wrapper over the solver's reductions (``solver.data_energy``,
``reg_energy_sobolev``, ``max_update_norm``) for code written against the
reference API. Each method reads its result to the host once.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sobfu_tpu_torch import fields as _fields
from sobfu_tpu_torch import solver as _solver


def _value_and_index(value: torch.Tensor, idx: torch.Tensor) -> Tuple[float, int]:
    """(float, int) of a device scalar and a flat index in one host read."""
    v, i = torch.stack([value.to(torch.float64), idx.to(torch.float64)]).tolist()
    return v, int(i)


class Reductor:
    """Reductions over dims (X, Y, Z) voxel grids (reference reductor.hpp:24-50)."""

    def __init__(self, dims_xyz: Tuple[int, int, int]):
        self.dims = tuple(int(d) for d in dims_xyz)

    # -- energies (reference reductor.cpp:38-50) ----------------------------
    def data_energy(self, phi_global: torch.Tensor, phi_n_psi: torch.Tensor) -> float:
        """0.5 * sum (phi_global - phi_n_psi)^2 (reduce_data_kernel,
        reductor.cu:11-112)."""
        return float(_solver.data_energy(phi_global, phi_n_psi))

    def reg_energy_sobolev(self, psi: torch.Tensor) -> float:
        """0.5 * sum ||J(disp(psi))||_F^2 (reduce_reg_sobolev_kernel,
        reductor.cu:114-214)."""
        return float(_solver.reg_energy_sobolev(psi))

    # -- convergence (reference reductor.cpp:52-57) -------------------------
    def max_update_norm(self, updates: torch.Tensor) -> Tuple[float, int]:
        """(max ||update||, flat argmax index) over f32[3,Z,Y,X]
        (reduce_max_kernel, reductor.cu:342-455)."""
        return _value_and_index(*_solver.max_update_norm(updates))

    def voxel_max_energy(self, phi_global: torch.Tensor, phi_n_psi: torch.Tensor,
                         psi: torch.Tensor, w_reg: float) -> Tuple[float, int]:
        """(max per-voxel energy, flat argmax index): the reference's
        reduce_voxel_max_energy_kernel (reductor.cu:216-340; defined there but
        never called), 0.5*(phi_g - phi_n_psi)^2 + 0.5*w_reg*||J(disp)||_F^2."""
        d = phi_global - phi_n_psi
        J = _fields.deformation_jacobian(psi)
        e = 0.5 * d * d + 0.5 * w_reg * torch.sum(J * J, dim=(0, 1))
        flat = e.reshape(-1)
        idx = torch.argmax(flat)
        return _value_and_index(flat[idx], idx)
