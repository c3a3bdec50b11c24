"""Field math: trilinear sampling, stencils, warps, deformation fields.

PyTorch counterpart of ``sobfu_tpu.fields`` (every function of it but the
TPU layout helpers and the hybrid window+exact sampler). Layouts are
the JAX package's:
  * scalar volumes are ``f32[Z, Y, X]``; the flat index of voxel (x, y, z)
    is ``(z * Y + y) * X + x``.
  * vector fields are ``f32[3, Z, Y, X]`` with channel order (x, y, z).
  * a deformation field ``psi`` stores ABSOLUTE target coordinates in voxel
    units (reference src/sobfu/cuda/vector_fields.cu:64-79).

Every function here is plain torch and runs on any device. They are the
reference semantics the CUDA kernels in :mod:`sobfu_tpu_torch.ops.kernels`
are held to.

Numerical contracts (see ``sobfu_tpu.fields``):
  * trilinear interpolation clamps coordinates to [0, dim-1]; the floor-
    corner rule samples the clamped floor voxel.
  * central differences and the negated Laplacian are ZERO on each axis's
    boundary slices.
  * the bounded-window samplers clip the coordinate to [0, dim-1] FIRST,
    then clamp the displacement to [-K, K-1e-4] (trilinear) or floor it and
    clamp to [-K, K] (floor rule). They are written here as the equivalent
    two-tap-per-axis gather of the JAX shift-sum: the zero-weight taps of
    the shift-sum add exact zeros, and the two live taps are accumulated in
    the same order, so the result is the same f32 value.
"""

from __future__ import annotations

from typing import Optional

import torch

from sobfu_tpu_torch.core import resolve_device


# ---------------------------------------------------------------------------
# stencils
# ---------------------------------------------------------------------------


def central_diff(f: torch.Tensor, axis: int) -> torch.Tensor:
    """(f[i+1] - f[i-1]) / 2 in the interior, 0 on the two boundary slices."""
    n = f.shape[axis]
    out = torch.zeros_like(f)
    out.narrow(axis, 1, n - 2).copy_(
        (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) * 0.5
    )
    return out


def second_diff(f: torch.Tensor, axis: int) -> torch.Tensor:
    """f[i+1] + f[i-1] - 2 f[i] in the interior, 0 on boundary slices."""
    n = f.shape[axis]
    out = torch.zeros_like(f)
    out.narrow(axis, 1, n - 2).copy_(
        f.narrow(axis, 2, n - 2)
        + f.narrow(axis, 0, n - 2)
        - 2.0 * f.narrow(axis, 1, n - 2)
    )
    return out


def conv1d_replicate(f: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """1-D correlation with edge-replicate padding along ``axis``.

    out[i] = sum_u taps[u] * f[clamp(i + r - u)], accumulated in u order —
    the reference's axis convolution (solver.cu:286-288). Shifted gathers,
    not ``F.conv*``: a cuDNN float32 convolution may run in TF32.
    """
    s = taps.shape[0]
    r = s // 2
    axis = axis % f.ndim
    n = f.shape[axis]
    base = torch.arange(n, device=f.device)
    out = torch.zeros_like(f)
    for u in range(s):
        idx = (base + (r - u)).clamp(0, n - 1)
        out = out + taps[u] * f.index_select(axis, idx)
    return out


# ---------------------------------------------------------------------------
# deformation field
# ---------------------------------------------------------------------------


def identity_field(dims_zyx, dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity deformation: psi[c, z, y, x] = (x, y, z)[c] in voxel units."""
    Z, Y, X = (int(d) for d in dims_zyx)
    zz, yy, xx = torch.meshgrid(
        torch.arange(Z, dtype=dtype, device=device),
        torch.arange(Y, dtype=dtype, device=device),
        torch.arange(X, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xx, yy, zz], dim=0)


def displacement(psi: torch.Tensor) -> torch.Tensor:
    """psi - identity (voxel units)."""
    return psi - identity_field(psi.shape[1:], psi.dtype, psi.device)


# ---------------------------------------------------------------------------
# exact trilinear / floor sampling
# ---------------------------------------------------------------------------


def _corner_indices(coords: torch.Tensor, dims_zyx):
    """Clamped floor/ceil corner indices + fractional weights.

    coords: f32[3, ...] channel order (x, y, z), voxel units.
    """
    Z, Y, X = dims_zyx
    cx = coords[0].clamp(0.0, X - 1)
    cy = coords[1].clamp(0.0, Y - 1)
    cz = coords[2].clamp(0.0, Z - 1)
    x0f, y0f, z0f = torch.floor(cx), torch.floor(cy), torch.floor(cz)
    fx, fy, fz = cx - x0f, cy - y0f, cz - z0f
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()
    x1 = (x0 + 1).clamp(max=X - 1)
    y1 = (y0 + 1).clamp(max=Y - 1)
    z1 = (z0 + 1).clamp(max=Z - 1)
    return (x0, y0, z0), (x1, y1, z1), (fx, fy, fz)


def _flat(x, y, z, X: int, Y: int):
    return (z * Y + y) * X + x


def _blend(c000, c100, c010, c110, c001, c101, c011, c111, fx, fy, fz):
    """Trilinear blend; c<abc> is the corner at x-offset a, y-offset b, z-offset c."""
    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def sample_trilinear(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Clamped trilinear sampling of a scalar volume f32[Z,Y,X] at
    coords f32[3, ...] (reference interpolate_tsdf, utils.hpp:51-86)."""
    return sample_field_trilinear(vol[None], coords)[0]


def sample_nearest_floor(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Value at the clamped floor corner (the reference's warped-weight rule)."""
    Z, Y, X = vol.shape
    (x0, y0, z0), _, _ = _corner_indices(coords, (Z, Y, X))
    return torch.take(vol, _flat(x0, y0, z0, X, Y))


def sample_field_trilinear(field: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Clamped trilinear sampling of f32[C,Z,Y,X] -> f32[C, ...]
    (reference interpolate_field, utils.hpp:88-122)."""
    C, Z, Y, X = field.shape
    (x0, y0, z0), (x1, y1, z1), (fx, fy, fz) = _corner_indices(coords, (Z, Y, X))
    v = field.reshape(C, -1)

    def take(xi, yi, zi):
        return v[:, _flat(xi, yi, zi, X, Y)]

    return _blend(
        take(x0, y0, z0), take(x1, y0, z0), take(x0, y1, z0), take(x1, y1, z0),
        take(x0, y0, z1), take(x1, y0, z1), take(x0, y1, z1), take(x1, y1, z1),
        fx[None], fy[None], fz[None],
    )


# ---------------------------------------------------------------------------
# bounded-window sampling (K-clamped displacement)
# ---------------------------------------------------------------------------


def _window_taps(c, v, n: int, K: int, floor_coords: bool):
    """Live taps of one axis of the window sampler: [(index, weight)].

    c: target coordinates; v: the voxel's own coordinate (broadcastable);
    n: axis extent. The floor rule has one tap of weight 1 (weight None).
    """
    c = c.clamp(0.0, n - 1)
    if floor_coords:
        d = (torch.floor(c) - v).clamp(-K, K)
        return [((v + d).long(), None)]
    d = (c - v).clamp(-K, K - 1e-4)
    o0 = torch.floor(d)
    o1 = o0 + 1.0
    w0 = (1.0 - torch.abs(d - o0)).clamp(min=0.0)
    w1 = (1.0 - torch.abs(d - o1)).clamp(min=0.0)
    return [
        ((v + o0).long().clamp(0, n - 1), w0),
        ((v + o1).long().clamp(0, n - 1), w1),
    ]


def _window_sample(vol, psi, K: int, floor_coords: bool):
    """Window sampler on f32[..., Z, Y, X] at psi f32[3, Z, Y, X]."""
    return _window_sample_zoffset(vol, psi, 0, K, floor_coords)


def _window_sample_zoffset(vol, psi_local, z0, K: int, floor_coords: bool, vol_z0: int = 0,
                           z_global: Optional[int] = None):
    """Window sampler of a z-block: psi_local f32[3, Zl, Y, X] covers global
    rows [z0, z0 + Zl) with absolute coordinates. vol f32[..., Zv, Y, X]
    holds global rows [vol_z0, vol_z0 + Zv) of a z_global-deep volume
    (default: vol is the whole volume). Coordinates, displacements and taps
    are clamped in global z, then a tap's global row is moved into vol's
    rows as an integer; vol must hold every row a tap reaches."""
    Zv, Y, X = vol.shape[-3:]
    Zl = psi_local.shape[-3]
    dev, dt = psi_local.device, psi_local.dtype
    vz = (torch.arange(Zl, dtype=dt, device=dev) + float(z0))[:, None, None]
    vy = torch.arange(Y, dtype=dt, device=dev)[None, :, None]
    vx = torch.arange(X, dtype=dt, device=dev)[None, None, :]
    tx = _window_taps(psi_local[0], vx, X, K, floor_coords)
    ty = _window_taps(psi_local[1], vy, Y, K, floor_coords)
    tz = [(iz - vol_z0, w) for iz, w in
          _window_taps(psi_local[2], vz, Zv if z_global is None else z_global, K, floor_coords)]
    flat = vol.reshape(vol.shape[:-3] + (-1,))

    def take(ix, iy, iz):
        return flat[..., (iz * Y + iy) * X + ix]

    if floor_coords:
        return take(tx[0][0], ty[0][0], tz[0][0])
    out = None
    for iz, wz in tz:
        acc_y = None
        for iy, wy in ty:
            (ix0, wx0), (ix1, wx1) = tx
            acc_x = wx0 * take(ix0, iy, iz) + wx1 * take(ix1, iy, iz)
            acc_y = wy * acc_x if acc_y is None else acc_y + wy * acc_x
        out = wz * acc_y if out is None else out + wz * acc_y
    return out


def sample_trilinear_window(vol, psi, max_disp: int = 4):
    """Trilinear sampling with the displacement clamped into the window
    [-K, K) (``sobfu_tpu.fields.sample_trilinear_window`` semantics);
    vol may carry leading channel dims f32[..., Z, Y, X]."""
    return _window_sample(vol, psi, int(max_disp), floor_coords=False)


def sample_nearest_floor_window(vol, psi, max_disp: int = 4):
    """Floor-corner sampling with the floored displacement clamped to
    [-K, K] (``sobfu_tpu.fields.sample_nearest_floor_window``)."""
    return _window_sample(vol, psi, int(max_disp), floor_coords=True)


def sample_trilinear_window_zoffset(vol_full, psi_local, z0, max_disp: int = 4):
    """Window trilinear sampling of a z-block (``sobfu_tpu.fields.
    sample_trilinear_window_zoffset``): psi_local f32[3, Zl, Y, X] covers
    global rows [z0, z0 + Zl) of vol_full f32[..., Z, Y, X] with absolute
    coordinates; window semantics of :func:`sample_trilinear_window`."""
    return _window_sample_zoffset(vol_full, psi_local, z0, int(max_disp), floor_coords=False)


def sample_nearest_floor_window_zoffset(vol_full, psi_local, z0, max_disp: int = 4):
    """Window floor-corner sampling of a z-block (the warped-weight rule)."""
    return _window_sample_zoffset(vol_full, psi_local, z0, int(max_disp), floor_coords=True)


# ---------------------------------------------------------------------------
# inverse deformation
# ---------------------------------------------------------------------------


def estimate_inverse(
    psi: torch.Tensor, iters: int = 48, init: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Fixed-point inverse psi_inv <- id - disp(psi) o psi_inv, ``iters``
    steps from ``init`` (None = identity; vector_fields.cu:111-138)."""
    ident = identity_field(psi.shape[1:], psi.dtype, psi.device)
    disp = psi - ident
    q = ident if init is None else init
    for _ in range(int(iters)):
        q = ident - sample_field_trilinear(disp, q)
    return q


def estimate_inverse_window(
    psi: torch.Tensor,
    iters: int = 48,
    max_disp: int = 4,
    init: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`estimate_inverse` with the window sampler (K = max_disp)."""
    ident = identity_field(psi.shape[1:], psi.dtype, psi.device)
    disp = psi - ident
    q = ident if init is None else init
    for _ in range(int(iters)):
        q = ident - sample_trilinear_window(disp, q, max_disp)
    return q


# ---------------------------------------------------------------------------
# differentiators
# ---------------------------------------------------------------------------

# volume axis for each coordinate: x -> axis 2 (X), y -> axis 1 (Y), z -> axis 0 (Z)
_COORD_AXIS = (2, 1, 0)


def tsdf_gradient(tsdf: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient -> f32[3,Z,Y,X] (x,y,z), zero on
    boundary slices (vector_fields.cu:157-208)."""
    return torch.stack([central_diff(tsdf, _COORD_AXIS[c]) for c in range(3)], dim=0)


def jacobian(field: torch.Tensor) -> torch.Tensor:
    """J[r, c] = d field_r / d x_c -> f32[3,3,Z,Y,X] (vector_fields.cu:415-472)."""
    return torch.stack(
        [
            torch.stack(
                [central_diff(field[r], _COORD_AXIS[c]) for c in range(3)], dim=0
            )
            for r in range(3)
        ],
        dim=0,
    )


def deformation_jacobian(psi: torch.Tensor) -> torch.Tensor:
    """Jacobian of the displacement field of psi (reference mode 1)."""
    return jacobian(displacement(psi))


def neg_laplacian(field: torch.Tensor) -> torch.Tensor:
    """Negated 6-neighbour Laplacian, per-axis term zero on that axis's
    boundary slices (vector_fields.cu:291-337); f32[..., Z, Y, X]."""
    return -(second_diff(field, -1) + second_diff(field, -2) + second_diff(field, -3))


def interpolate_gradient(tsdf: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Gradient of a tsdf sampled at psi: (grad tsdf) o psi -> f32[3,Z,Y,X]
    (the reference's interpolate_gradient, vector_fields.cu:210-240)."""
    return sample_field_trilinear(tsdf_gradient(tsdf), psi)


def interpolate_laplacian(field: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Negated Laplacian of a field sampled at psi (vector_fields.cu:242-272)."""
    return sample_field_trilinear(neg_laplacian(field), psi)


def warp_tsdf(tsdf: torch.Tensor, weight: torch.Tensor, psi: torch.Tensor):
    """phi o psi: (tsdf, weight) sampled at the absolute coordinates in psi,
    trilinear for the tsdf and floor-corner for the weight (the reference's
    apply_kernel, vector_fields.cu:81-100). Plain torch on any device;
    :meth:`DeformationField.apply` runs the same rule through kernel B."""
    return sample_trilinear(tsdf, psi), sample_nearest_floor(weight, psi)


# ---------------------------------------------------------------------------
# host-facing DeformationField wrapper
# ---------------------------------------------------------------------------


class DeformationField:
    """psi wrapper (reference sobfu::cuda::DeformationField,
    include/sobfu/vector_fields.hpp:59-112). dims is (X, Y, Z); data is
    f32[3,Z,Y,X] on ``device`` (the card by default; data keeps its own)."""

    def __init__(self, dims_xyz, data: Optional[torch.Tensor] = None, device="cuda"):
        self.dims = tuple(int(d) for d in dims_xyz)
        zyx = (self.dims[2], self.dims[1], self.dims[0])
        self.data = identity_field(zyx, device=resolve_device(device)) if data is None else data

    def clear(self) -> None:
        """Reset to the identity (the reference's 'clear' for psi)."""
        self.data = identity_field(self.data.shape[1:], self.data.dtype, self.data.device)

    def get_displacement(self) -> torch.Tensor:
        return displacement(self.data)

    def apply(self, tsdf: torch.Tensor, weight: torch.Tensor):
        from sobfu_tpu_torch.ops import kernels

        out = kernels.warp(torch.stack([tsdf, weight]), self.data, None, (False, True))
        return out[0], out[1]

    def get_inverse(self, iters: int = 48) -> "DeformationField":
        from sobfu_tpu_torch.ops import kernels

        return DeformationField(
            self.dims, kernels.inverse_fixed_point(self.data, iters, None), self.data.device
        )

    def no_nans(self) -> bool:
        return not bool(torch.isnan(self.data).any())
