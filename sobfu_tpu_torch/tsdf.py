"""TSDF volumes: projective integration, volume fusion, analytic SDFs.

PyTorch counterpart of ``sobfu_tpu.tsdf``. State is a pair of tensors
``tsdf: f32[Z,Y,X]`` (normalised to [-1, 1]) and ``weight: f32[Z,Y,X]`` on
the volume's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sobfu_tpu_torch.config import Intr, Params
from sobfu_tpu_torch.core import resolve_device


def voxel_centers(dims_zyx, voxel_sizes_xyz, device=None) -> torch.Tensor:
    """Metric voxel centres -> f32[3,Z,Y,X], channels (x,y,z)
    (reference tsdf_volume.cu:70-74)."""
    Z, Y, X = dims_zyx
    vsx, vsy, vsz = (torch.as_tensor(v, dtype=torch.float32) for v in voxel_sizes_xyz)
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=device) + 0.5  # noqa: E731
    zz, yy, xx = torch.meshgrid(
        ar(Z) * vsz.to(device), ar(Y) * vsy.to(device), ar(X) * vsx.to(device),
        indexing="ij",
    )
    return torch.stack([xx, yy, zz], dim=0)


def _truncate(sdf: torch.Tensor, trunc_dist) -> torch.Tensor:
    return torch.clamp(sdf / trunc_dist, -1.0, 1.0)


def integrate_dists(
    tsdf: torch.Tensor,
    weight: torch.Tensor,
    dists: torch.Tensor,
    vol2cam: np.ndarray,
    intr: Intr,
    voxel_sizes,
    trunc_dist: float,
    eta: float,
    axis_aligned: bool = False,
    z_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projective TSDF integration of a metric ray-length ('dists') map
    (reference tsdf_volume.cu:62-101): per voxel, project the centre, read
    dists at the floor pixel, psdf = Dp - z_cam; weight = psdf > -eta,
    value = clip(psdf / trunc, -1, 1). Voxels outside the image, with
    Dp <= 0 or z_cam <= 0 keep their previous (tsdf, weight).

    axis_aligned: the caller certifies vol2cam[:3,:3] == I. Then
    u = fx*xs*(1/zs) + cx depends on (z, x) only and v on (z, y) only — the
    arithmetic of the JAX package's separable path — and the image read
    is a direct index dists[v(z,y), u(z,x)].

    z_offset: the global z of the volume's first row (a z-slab of a sharded
    volume integrates its own rows).

    CPU tensors run the plain version (``frontend.integrate_dists_plain``);
    CUDA tensors launch kernel I (``csrc/integrate.cu``) or raise.
    """
    from sobfu_tpu_torch.ops import frontend  # it imports this module

    return frontend.integrate_dists(tsdf, weight, dists, vol2cam, intr, voxel_sizes, trunc_dist,
                                    eta, axis_aligned, z_offset)


def _blend_numerator(tsdf_g, weight_g, tsdf_n):
    """weight_g * tsdf_g + tsdf_n as ONE fused multiply-add (torch.addcmul),
    the rounding XLA gives ``sobfu_tpu.tsdf.fuse_volumes`` and the
    warp_fuse kernel's __fmaf_rn: the three agree bit for bit."""
    return torch.addcmul(tsdf_n, weight_g, tsdf_g)


def fuse_volumes(tsdf_g, weight_g, tsdf_n, weight_n, max_weight):
    """Running weighted average of a warped live volume into the global one
    (reference tsdf_volume.cu:103-130): skip voxels whose incoming weight is
    0, or 1 with tsdf in {0, -1}; otherwise
        t_new = (w_prev * t_prev + t) / (w_prev + 1)
        w_new = min(w_prev + 1, max_weight)
    """
    skip = (weight_n == 0.0) | (
        (weight_n == 1.0) & ((tsdf_n == 0.0) | (tsdf_n == -1.0))
    )
    t_new = _blend_numerator(tsdf_g, weight_g, tsdf_n) / (weight_g + 1.0)
    w_new = torch.clamp(weight_g + 1.0, max=float(np.float32(max_weight)))
    return torch.where(skip, tsdf_g, t_new), torch.where(skip, weight_g, w_new)


def fuse_volumes_gated(tsdf_g, weight_g, tsdf_n, weight_n, max_weight, disp_norm, gate_vox):
    """:func:`fuse_volumes` where a voxel without canonical support
    (weight_g == 0) accepts new surface only where disp_norm <= gate_vox
    (``sobfu_tpu.tsdf.fuse_volumes_gated``; NEW_SURFACE_GATE)."""
    skip = (weight_n == 0.0) | (
        (weight_n == 1.0) & ((tsdf_n == 0.0) | (tsdf_n == -1.0))
    )
    skip = skip | ((weight_g == 0.0) & (disp_norm > np.float32(gate_vox)))
    t_new = _blend_numerator(tsdf_g, weight_g, tsdf_n) / (weight_g + 1.0)
    w_new = torch.clamp(weight_g + 1.0, max=float(np.float32(max_weight)))
    return torch.where(skip, tsdf_g, t_new), torch.where(skip, weight_g, w_new)


def init_sphere(dims_zyx, voxel_sizes_xyz, centre_xyz, radius, trunc_dist, eta, device=None):
    """SDF of a sphere; weight = (sdf > -eta) (reference tsdf_volume.cu:249-275)."""
    vc = voxel_centers(dims_zyx, voxel_sizes_xyz, device=device)
    c = torch.as_tensor(np.asarray(centre_xyz, np.float32), device=device)
    sdf = torch.linalg.vector_norm(vc - c[:, None, None, None], dim=0) - np.float32(radius)
    w = torch.where(sdf > -np.float32(eta), 1.0, 0.0)
    return _truncate(sdf, np.float32(trunc_dist)), w


def _centered_coords(dims_zyx, voxel_sizes_xyz, device=None) -> torch.Tensor:
    """Voxel centres relative to the volume's centre."""
    Z, Y, X = dims_zyx
    vsx, vsy, vsz = voxel_sizes_xyz
    c = torch.tensor(np.asarray([X / 2.0 * vsx, Y / 2.0 * vsy, Z / 2.0 * vsz], np.float32),
                     device=device)
    return voxel_centers(dims_zyx, voxel_sizes_xyz, device=device) - c[:, None, None, None]


def _norm0(a: torch.Tensor) -> torch.Tensor:
    """sqrt of the sum of squares over axis 0 (``jnp.linalg.norm(a, axis=0)``)."""
    return torch.sqrt(torch.sum(a * a, dim=0))


def _ones(dims_zyx, device):
    return torch.ones(tuple(dims_zyx), dtype=torch.float32, device=device)


def init_box(dims_zyx, voxel_sizes_xyz, half_extent_xyz, trunc_dist, device=None):
    """SDF of an axis-aligned box centred in the volume (tsdf_volume.cu:181-213)."""
    vc = _centered_coords(dims_zyx, voxel_sizes_xyz, device)
    b = torch.tensor(np.asarray(half_extent_xyz, np.float32), device=device)
    d = torch.abs(vc) - b[:, None, None, None]
    outside = _norm0(torch.clamp(d, min=0.0))
    inside = torch.clamp(torch.amax(d, dim=0), max=0.0)
    return _truncate(inside + outside, np.float32(trunc_dist)), _ones(dims_zyx, device)


def init_ellipsoid(dims_zyx, voxel_sizes_xyz, radii_xyz, trunc_dist, device=None):
    """Approximate ellipsoid SDF (tsdf_volume.cu:215-247)."""
    vc = _centered_coords(dims_zyx, voxel_sizes_xyz, device)
    r = torch.tensor(np.asarray(radii_xyz, np.float32), device=device)[:, None, None, None]
    k0 = _norm0(vc / r)
    k1 = _norm0(vc / (r * r))
    return _truncate(k0 * (k0 - 1.0) / k1, np.float32(trunc_dist)), _ones(dims_zyx, device)


def init_plane(dims_zyx, voxel_sizes_xyz, z_plane, trunc_dist, device=None):
    """SDF of the plane z = z_plane, NOT centred (tsdf_volume.cu:277-301)."""
    vc = voxel_centers(dims_zyx, voxel_sizes_xyz, device=device)
    return _truncate(vc[2] - np.float32(z_plane), np.float32(trunc_dist)), _ones(dims_zyx, device)


def init_torus(dims_zyx, voxel_sizes_xyz, major_r, minor_r, trunc_dist, device=None):
    """SDF of a torus in the x-z plane, centred (tsdf_volume.cu:303-334)."""
    vc = _centered_coords(dims_zyx, voxel_sizes_xyz, device)
    q = torch.sqrt(vc[0] * vc[0] + vc[2] * vc[2]) - np.float32(major_r)
    sdf = torch.sqrt(q * q + vc[1] * vc[1]) - np.float32(minor_r)
    return _truncate(sdf, np.float32(trunc_dist)), _ones(dims_zyx, device)


class TsdfVolume:
    """Reference kfusion::cuda::TsdfVolume surface (dims/size (X, Y, Z);
    arrays [Z, Y, X] on ``device``, the card by default)."""

    def __init__(self, params: Params, device="cuda"):
        self.device = resolve_device(device)
        self.dims = tuple(int(d) for d in params.volume_dims)  # (X, Y, Z)
        self.size = tuple(float(s) for s in params.volume_size)
        self.pose = np.asarray(params.volume_pose, dtype=np.float32)
        self.trunc_dist = float(params.tsdf_trunc_dist)
        self.eta = float(params.eta)
        self.max_weight = float(params.tsdf_max_weight)
        self.gradient_delta_factor = float(params.gradient_delta_factor)
        self.clear()

    @property
    def dims_zyx(self) -> Tuple[int, int, int]:
        return (self.dims[2], self.dims[1], self.dims[0])

    def voxel_sizes(self) -> Tuple[float, float, float]:
        return tuple(self.size[i] / self.dims[i] for i in range(3))

    def clear(self) -> None:
        self.tsdf = torch.zeros(self.dims_zyx, dtype=torch.float32, device=self.device)
        self.weight = torch.zeros(self.dims_zyx, dtype=torch.float32, device=self.device)

    def integrate(self, dists: torch.Tensor, camera_pose: np.ndarray, intr: Intr) -> None:
        """Depth-map (dists) integration; camera_pose is a 4x4 affine."""
        vol2cam = np.linalg.inv(np.asarray(camera_pose, np.float32)) @ self.pose
        self.tsdf, self.weight = integrate_dists(
            self.tsdf, self.weight, dists, vol2cam, intr, self.voxel_sizes(),
            self.trunc_dist, self.eta,
            axis_aligned=bool(np.allclose(vol2cam[:3, :3], np.eye(3), atol=1e-6)),
        )

    def integrate_volume(self, other: "TsdfVolume") -> None:
        """Fuse another (warped live) volume into this one."""
        self.tsdf, self.weight = fuse_volumes(
            self.tsdf, self.weight, other.tsdf, other.weight, self.max_weight
        )

    def init_sphere(self, centre_xyz, radius) -> None:
        self.tsdf, self.weight = init_sphere(
            self.dims_zyx, self.voxel_sizes(), centre_xyz, radius,
            self.trunc_dist, self.eta, device=self.device,
        )

    def init_box(self, half_extent_xyz) -> None:
        self.tsdf, self.weight = init_box(
            self.dims_zyx, self.voxel_sizes(), half_extent_xyz, self.trunc_dist, self.device
        )

    def init_ellipsoid(self, radii_xyz) -> None:
        self.tsdf, self.weight = init_ellipsoid(
            self.dims_zyx, self.voxel_sizes(), radii_xyz, self.trunc_dist, self.device
        )

    def init_plane(self, z_plane) -> None:
        self.tsdf, self.weight = init_plane(
            self.dims_zyx, self.voxel_sizes(), z_plane, self.trunc_dist, self.device
        )

    def init_torus(self, major_r, minor_r) -> None:
        self.tsdf, self.weight = init_torus(
            self.dims_zyx, self.voxel_sizes(), major_r, minor_r, self.trunc_dist, self.device
        )

    def apply_affine(self, affine: np.ndarray) -> None:
        """Compose an affine onto the volume pose (reference applyAffine)."""
        self.pose = (np.asarray(affine, np.float32) @ self.pose).astype(np.float32)

    def swap(self, other: "TsdfVolume") -> None:
        """Exchange voxel data with another volume (reference swap)."""
        self.tsdf, other.tsdf = other.tsdf, self.tsdf
        self.weight, other.weight = other.weight, self.weight

    def print_sdf_values(self, z: int = None) -> None:
        """Print the tsdf values of one z-slice, the middle one by default
        (reference print_sdf_values, tsdf_volume.cpp:148-163)."""
        z = self.dims_zyx[0] // 2 if z is None else int(z)
        print(self.tsdf[z].cpu().numpy())
