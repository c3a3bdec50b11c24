"""Scalar voxel fields.

PyTorch counterpart of ``sobfu_tpu.scalar_fields`` (reference
``sobfu::cuda::ScalarField``, include/sobfu/scalar_fields.hpp:19-78): a
float-per-voxel field with ``clear`` and an all-voxel ``sum``. The main
pipeline never builds one; it exists for code written against the
reference API.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sobfu_tpu_torch.core import resolve_device


class ScalarField:
    """float-per-voxel 3-D field. dims is (X, Y, Z); data is f32[Z, Y, X] on
    ``device`` (the card by default; given data keeps its own)."""

    def __init__(self, dims_xyz: Tuple[int, int, int], data: Optional[torch.Tensor] = None,
                 device="cuda"):
        self.dims = tuple(int(d) for d in dims_xyz)
        zyx = (self.dims[2], self.dims[1], self.dims[0])
        if data is None:
            data = torch.zeros(zyx, dtype=torch.float32, device=resolve_device(device))
        self.data = data

    def clear(self) -> None:
        self.data = torch.zeros_like(self.data)

    def sum(self) -> float:
        """Sum over all voxels (reference reduce_sum, scalar_fields.hpp:72-76):
        one host read."""
        return float(torch.sum(self.data))

    def print(self) -> None:  # parity with the reference debug printer
        print(self.data.cpu().numpy())
