"""Marching cubes: TSDF volume -> triangle soup (plain torch).

PyTorch counterpart of ``sobfu_tpu.mc`` (reference
src/kfusion/cuda/marching_cubes.cu): cube classification with the
zero-weight early-out, compaction of occupied cubes in flat-index order,
12-edge interpolation, flat per-triangle normals, pose and the reference's
(x, -y, -z) store convention. Triangles come out in the JAX package's order.

The lookup tables are the port's own copy, ``mc_tables.npz`` beside this
module (the JAX package's tables, byte for byte).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mc_tables.npz")

# cube corner offsets (x, y, z), reference marching_cubes.cu:222-230
CORNERS = np.asarray(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    dtype=np.int64,
)
# the 12 cube edges as (corner_a, corner_b), reference marching_cubes.cu:235-246
EDGES = np.asarray(
    [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6),
     (6, 7), (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)],
    dtype=np.int64,
)

# the reference's fixed output buffer (marching_cubes.hpp:22)
DEFAULT_MAX_VERTICES = 6_000_000
DEFAULT_MAX_OCCUPIED = 1 << 20


def load_tables():
    """(tri_table i64[256,16], num_verts_table i64[256])."""
    with np.load(_TABLE_PATH) as t:
        return (
            np.asarray(t["tri_table"], np.int64),
            np.asarray(t["num_verts_table"], np.int64),
        )


@dataclasses.dataclass
class Mesh:
    """Triangle soup: consecutive vertex triples form triangles."""

    vertices: np.ndarray  # f32[n, 3]
    normals: np.ndarray  # f32[n, 3]
    colors: "np.ndarray | None" = None

    @property
    def n_triangles(self) -> int:
        return self.vertices.shape[0] // 3

    def polygons(self) -> np.ndarray:
        return np.arange(self.vertices.shape[0], dtype=np.int64).reshape(-1, 3)


def classify_cubes(tsdf: torch.Tensor, weight: torch.Tensor, num_verts_table, iso=0.0):
    """Cube index + vertex count per cell (marching_cubes.cu:40-79): bit i
    set iff corner i's tsdf < iso; 0 when any corner weight is 0."""
    Z, Y, X = tsdf.shape
    idx = torch.zeros((Z - 1, Y - 1, X - 1), dtype=torch.int64, device=tsdf.device)
    all_weighted = None
    for i, (dx, dy, dz) in enumerate(CORNERS):
        f = tsdf[dz:dz + Z - 1, dy:dy + Y - 1, dx:dx + X - 1]
        w = weight[dz:dz + Z - 1, dy:dy + Y - 1, dx:dx + X - 1]
        idx = idx + (f < iso).long() * (1 << i)
        ok = w != 0.0
        all_weighted = ok if all_weighted is None else (all_weighted & ok)
    idx = torch.where(all_weighted, idx, 0)
    return idx, num_verts_table[idx]


def marching_cubes(tsdf, weight, cell_size, pose, iso: float = 0.0,
                   max_occupied: int = DEFAULT_MAX_OCCUPIED,
                   max_vertices: int = DEFAULT_MAX_VERTICES, flip_yz: bool = True):
    """Iso-surface -> (vertices f32[n,3], normals f32[n,3]) on tsdf's device,
    at most max_occupied cubes and max_vertices vertices, as the JAX
    package's fixed-capacity buffers truncate."""
    dev = tsdf.device
    tri_np, nv_np = load_tables()
    tri_table = torch.as_tensor(tri_np, device=dev)
    nv_table = torch.as_tensor(nv_np, device=dev)
    Z, Y, X = tsdf.shape
    cube_idx, n_verts = classify_cubes(tsdf, weight, nv_table, iso)
    occ_ids = torch.nonzero(n_verts.reshape(-1) > 0).reshape(-1)[:max_occupied]
    occ_ci = cube_idx.reshape(-1)[occ_ids]
    occ_nv = nv_table[occ_ci]

    cx = occ_ids % (X - 1)
    cy = (occ_ids // (X - 1)) % (Y - 1)
    cz = occ_ids // ((X - 1) * (Y - 1))
    cs = torch.as_tensor(np.asarray(cell_size, np.float32), device=dev)
    tsdf_flat = tsdf.reshape(-1)
    f, p = [], []
    for dx, dy, dz in CORNERS:
        flat = ((cz + dz) * Y + (cy + dy)) * X + (cx + dx)
        f.append(tsdf_flat[flat])
        p.append(
            torch.stack(
                [
                    (cx + dx).to(torch.float32).add(0.5) * cs[0],
                    (cy + dy).to(torch.float32).add(0.5) * cs[1],
                    (cz + dz).to(torch.float32).add(0.5) * cs[2],
                ],
                dim=-1,
            )
        )
    f = torch.stack(f, dim=0)  # [8, n]
    p = torch.stack(p, dim=0)  # [8, n, 3]

    # 12 edge-interpolated vertices (vertex_interp, marching_cubes.cu:196-203)
    edge_pts = []
    for a, b in EDGES:
        t = (iso - f[a]) / (f[b] - f[a] + np.float32(1e-15))
        edge_pts.append(p[a] + t[:, None] * (p[b] - p[a]))
    edge_pts = torch.stack(edge_pts, dim=1)  # [n, 12, 3]

    sel = tri_table[occ_ci][:, :15].clamp(0, 11)  # [n, 15]
    verts = torch.gather(edge_pts, 1, sel[:, :, None].expand(-1, -1, 3))  # [n, 15, 3]

    # flat per-triangle normals: n = normalize((v3-v1) x (v2-v1)) (marching_cubes.cu:260)
    v1, v2, v3 = verts[:, 0::3], verts[:, 1::3], verts[:, 2::3]
    n = torch.linalg.cross(v3 - v1, v2 - v1, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    normals = torch.repeat_interleave(n, 3, dim=1)  # [n, 15, 3]

    pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
    verts = torch.einsum("cvj,ij->cvi", verts, pose_t[:3, :3]) + pose_t[:3, 3]
    if flip_yz:
        flip = torch.tensor([1.0, -1.0, -1.0], device=dev)
        verts = verts * flip
        normals = normals * flip

    slot = torch.arange(15, device=dev)[None, :]
    valid = slot < occ_nv[:, None]
    verts = verts[valid][:max_vertices]
    normals = normals[valid][:max_vertices]
    return verts, normals


def extract_mesh(tsdf, weight, voxel_sizes, pose: Optional[np.ndarray] = None,
                 iso: float = 0.0, max_occupied: Optional[int] = None,
                 max_vertices: Optional[int] = None, flip_yz: bool = True) -> Mesh:
    """Run marching cubes and return the mesh on the host. Capacities
    default to min(reference cap, worst case for this grid), as in the JAX
    package."""
    if pose is None:
        pose = np.eye(4, dtype=np.float32)
    n_cells = int(np.prod(tsdf.shape))
    if max_occupied is None:
        max_occupied = min(DEFAULT_MAX_OCCUPIED, n_cells)
    if max_vertices is None:
        max_vertices = min(DEFAULT_MAX_VERTICES, 15 * max_occupied)
    v, n = marching_cubes(
        tsdf, weight, voxel_sizes, pose, iso=iso, max_occupied=max_occupied,
        max_vertices=max_vertices, flip_yz=flip_yz,
    )
    return Mesh(vertices=v.cpu().numpy(), normals=n.cpu().numpy())
