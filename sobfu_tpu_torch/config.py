"""Configuration: camera intrinsics, solver/volume parameters, .ini parsing.

The PyTorch port reads the same keys as ``sobfu_tpu.config`` and fills the
same ``Params`` fields (numpy only; no jax). Keys that select TPU-only
dispatch (USE_PALLAS, WARP_PALLAS, Z_CHUNKS, CONV_MXU) are parsed and have
no effect in the port.

Mirrors the reference parameter surface exactly:
  * ``Params`` fields      -> reference include/sobfu/params.hpp:7-38
  * ``.ini`` key inventory -> reference src/apps/demo.cpp:87-160
  * voxel-unit -> metric conversion of TSDF_TRUNC_DIST / ETA and the
    volume pose built from VOL_POSE_T_Z -> reference src/apps/demo.cpp:71-74

The reference's scene configs under ``params/*.ini`` parse unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np


class Intr(NamedTuple):
    """Pinhole camera intrinsics (reference include/kfusion/types.hpp:28-34).

    ``level(n)`` scales for pyramid level n, matching the reference's
    ``Intr::operator()(int)`` used by ICP.
    """

    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0

    def level(self, level_index: int) -> "Intr":
        div = 1 << level_index
        return Intr(self.fx / div, self.fy / div, self.cx / div, self.cy / div)


def translation_pose(t: Tuple[float, float, float]) -> np.ndarray:
    """4x4 affine with identity rotation and translation t."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = t
    return pose


@dataclasses.dataclass
class Params:
    """Flat config struct, field-for-field parity with the reference Params."""

    # frame geometry
    cols: int = 640
    rows: int = 480

    # volume geometry: dims in voxels (x, y, z), size in metres
    volume_dims: Tuple[int, int, int] = (128, 128, 128)
    volume_size: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    volume_pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )

    intr: Intr = Intr(570.342, 570.342, 320.0, 240.0)

    icp_truncate_depth_dist: float = 0.0  # TRUNC_DEPTH (metres)

    bilateral_sigma_depth: float = 0.04
    bilateral_sigma_spatial: float = 4.5
    bilateral_kernel_size: int = 7

    tsdf_trunc_dist: float = 0.0  # metres (after voxel->metre conversion)
    eta: float = 0.0  # metres (after voxel->metre conversion)
    tsdf_max_weight: float = 64.0

    gradient_delta_factor: float = 0.5

    start_frame: int = 0
    verbosity: int = 0

    # solver
    s: int = 7
    max_iter: int = 2048
    max_update_norm: float = 0.1
    lambda_: float = 0.1
    alpha: float = 0.001
    w_reg: float = 0.2

    # TPU extensions (no reference counterpart):
    # bounded-window warp half-width in voxels for the gather-free trilinear
    # sampler; None = exact gather.
    warp_window: "int | None" = None
    # fused Pallas solver iterations; strictly opt-in (requires warp_window).
    use_pallas: "bool | None" = None
    # "additive" = reference-faithful updates (psi -= a*dU_S);
    # "compositive" = psi0 o (id + delta) — unbounded accumulated
    # deformation with the bounded-window warp (TPU fast mode).
    solver_mode: str = "additive"
    # heavy-ball momentum coefficient; None = plain GD (reference-faithful).
    momentum: "float | None" = None
    # split the solve state into this many z-chunks (restores XLA fusion on
    # large grids; requires warp_window). None = auto (8 when warp_window is
    # set and the grid is >= 128 deep); 0 = monolithic.
    z_chunks: "int | None" = None
    # evaluate the Sobolev axis convolutions as banded-matrix contractions
    # on the MXU instead of shifted VPU passes. None = auto (on for TPU
    # backends, off on CPU where there is no systolic array to win on).
    conv_mxu: "bool | None" = None
    # run the bounded-window warps of the monolithic solve as the pipelined
    # Pallas kernel (ops/pallas_kernels.window_warp_pallas): measured 1.6x
    # faster full iterations at 128^3 (bit-identical results). Opt-in — the
    # pool's Mosaic compile helper is intermittently unavailable.
    warp_pallas: "bool | None" = None
    # fixed-point iterations for the inverse deformation field. None =
    # reference parity (48, vector_fields.cu:122); production window-mode
    # runs pair INVERSE_WARM with a smaller count.
    inverse_iters: "int | None" = None
    # warm-start the inverse fixed point from the previous frame's inverse
    # (additive window mode): same accuracy as 48-from-identity in ~12
    # iterations (the fixed point moves little per frame). None = auto
    # (on when a warp window is set).
    inverse_warm: "bool | None" = None
    # coarse-to-fine solve: estimate the low-frequency deformation on
    # 2x-downsampled volumes first (8x cheaper per iteration), then refine
    # at full resolution — same fixed point, fewer fine iterations
    # (additive mode; composes with momentum and the fused kernel). 1 = off.
    pyramid_levels: int = 1
    # run each gradient-descent iteration as ONE double-buffered fused
    # Pallas kernel (ops/pallas_kernels.fused_gd_iteration_db): stencils +
    # potential gradient + Sobolev convolutions + update + windowed warp in
    # a single VMEM-resident pass. None = auto (on for TPU when the grid
    # tiles evenly and a warp window is in effect); False = force the
    # XLA paths.
    fused_pallas: "bool | None" = None
    # compositive mode only: maintain psi_inv incrementally across frames
    # (invert the bounded increment with the window sampler + compose with
    # the previous inverse + exact refinement anchor) instead of 48 exact
    # gathers from identity each frame. None = on (compositive default).
    incremental_inverse: "bool | None" = None
    # pyramid fine level as a compositive K=FINE_WINDOW increment solve
    # (typically 1): the coarse levels absorb the bulk motion so the fine
    # increment is sub-voxel and the fused kernel's warp shrinks from 5^3
    # to 3^3 taps (~1.7x faster fine iterations). None = additive fine
    # level (exact reference semantics). Needs PYRAMID_LEVELS >= 2.
    fine_window: "int | None" = None
    # data-energy stall detector (solver.estimate_psi docstring): stop when
    # a STALL_WINDOW-iteration checkpoint improves the data energy by less
    # than STALL_REL (relative). In warm-started frame sequences the
    # update-norm criterion plateaus on regulariser drift of the
    # accumulated field and every frame burns the full iteration cap —
    # exactly like the reference, whose shipped configs run 2048-8192
    # iterations at cap. 0 = off (reference stopping semantics).
    stall_window: int = 0
    stall_rel: float = 1e-3
    # surface-confidence fusion gate (tsdf.fuse_volumes_gated; BEYOND-
    # reference — the reference fuses everywhere): a voxel with NO
    # canonical support (weight 0) may receive newly-seen live surface
    # only where |psi - id|_inf <= this many voxels (static background
    # reveal); elsewhere psi is regulariser-extrapolated and the new
    # surface would land at the wrong canonical location (measured on the
    # scene-config articulated separation: canonical RMSE 5.5 vox without
    # the gate). 0 = off (reference fusion semantics — the default).
    new_surface_gate: float = 0.0
    # Y-folded fused path (X=64 grids) only: run N gradient-descent
    # iterations per kernel launch with ALL loop state VMEM-resident
    # (solver.estimate_psi inner_steps). Convergence/stall stops are
    # checked every N iterations (may overshoot a mid-chunk stop by up to
    # N-1 iterations; exact for fixed-iteration runs when MAX_ITER % N
    # == 0). 16 is the measured sweet spot at 64^3. 0 = off (exact
    # single-step stopping semantics — the default).
    inner_steps: int = 0
    # coarse-to-fine warm inverse (solver.estimate_inverse_multigrid):
    # run the inverse fixed point at half resolution + 1 full-res anchor
    # step (~24.5 -> ~14 ms at 256^3). None = AUTO: on exactly for the
    # fused compositive production config (fused_pallas + fine_window),
    # where it replaces the warm full-res fixed point with an approximate
    # inverse measured at <= 2.3e-3 voxel off cold-48 with a PREVIOUS-
    # frame warm start (tools/check_inverse_multigrid.py; composition
    # residual identical to warm-3 full-res). Set False to keep the exact
    # full-resolution fixed point in that config too.
    inv_multigrid: "bool | None" = None

    def voxel_sizes(self) -> Tuple[float, float, float]:
        return (
            self.volume_size[0] / self.volume_dims[0],
            self.volume_size[1] / self.volume_dims[1],
            self.volume_size[2] / self.volume_dims[2],
        )


# .ini key -> (attribute, converter). Matches demo.cpp:92-159.
_SCALAR_KEYS = {
    "TSDF_MAX_WEIGHT": ("tsdf_max_weight", float),
    "GRADIENT_DELTA_FACTOR": ("gradient_delta_factor", float),
    "TRUNC_DEPTH": ("icp_truncate_depth_dist", float),
    "BILATERAL_SIGMA_DEPTH": ("bilateral_sigma_depth", float),
    "BILATERAL_SIGMA_SPATIAL": ("bilateral_sigma_spatial", float),
    "BILATERAL_KERNEL_SIZE": ("bilateral_kernel_size", int),
    "START_FRAME": ("start_frame", int),
    "MAX_ITER": ("max_iter", int),
    "MAX_UPDATE_NORM": ("max_update_norm", float),
    "S": ("s", int),
    "LAMBDA": ("lambda_", float),
    "ALPHA": ("alpha", float),
    "W_REG": ("w_reg", float),
}


def _parse_ini(path: str) -> dict:
    """Parse the reference's flat KEY=VALUE .ini format ('#' comments)."""
    values = {}
    with open(path, "r") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, _, val = line.partition("=")
            values[key.strip()] = val.strip()
    return values


def load_params(path: str, verbosity: int = 0) -> Params:
    """Load a scene .ini (reference params/*.ini) into Params.

    Applies the same voxel-unit conversions as the reference app
    (demo.cpp:71-74): TSDF_TRUNC_DIST and ETA are given in voxels and
    multiplied by the x voxel size; the volume pose translates the volume
    so it is centred in x/y with the camera VOL_POSE_T_Z metres away in z.
    """
    vm = _parse_ini(path)
    p = Params(verbosity=verbosity)

    dims = list(p.volume_dims)
    size = list(p.volume_size)
    for i, axis in enumerate("XYZ"):
        if f"VOL_DIMS_{axis}" in vm:
            dims[i] = int(vm[f"VOL_DIMS_{axis}"])
        if f"VOL_SIZE_{axis}" in vm:
            size[i] = float(vm[f"VOL_SIZE_{axis}"])
    p.volume_dims = tuple(dims)
    p.volume_size = tuple(size)

    intr = dict(zip("fx fy cx cy".split(), p.intr))
    for key, attr in [("INTR_FX", "fx"), ("INTR_FY", "fy"), ("INTR_CX", "cx"), ("INTR_CY", "cy")]:
        if key in vm:
            intr[attr] = float(vm[key])
    p.intr = Intr(**intr)

    for key, (attr, conv) in _SCALAR_KEYS.items():
        if key in vm:
            setattr(p, attr, conv(vm[key]))

    # TPU extension keys (optional; not present in reference configs)
    if "WARP_WINDOW" in vm:
        p.warp_window = int(vm["WARP_WINDOW"])
    if "USE_PALLAS" in vm:
        p.use_pallas = vm["USE_PALLAS"].strip().lower() in ("1", "true", "yes")
    if "SOLVER_MODE" in vm:
        mode = vm["SOLVER_MODE"].strip().lower()
        assert mode in ("additive", "compositive"), mode
        p.solver_mode = mode
    if "MOMENTUM" in vm:
        p.momentum = float(vm["MOMENTUM"])
    if "Z_CHUNKS" in vm:
        p.z_chunks = int(vm["Z_CHUNKS"])
    if "CONV_MXU" in vm:
        p.conv_mxu = vm["CONV_MXU"].strip().lower() in ("1", "true", "yes")
    if "WARP_PALLAS" in vm:
        p.warp_pallas = vm["WARP_PALLAS"].strip().lower() in ("1", "true", "yes")
    if "INVERSE_ITERS" in vm:
        p.inverse_iters = int(vm["INVERSE_ITERS"])
    if "INVERSE_WARM" in vm:
        p.inverse_warm = vm["INVERSE_WARM"].strip().lower() in ("1", "true", "yes")
    if "PYRAMID_LEVELS" in vm:
        p.pyramid_levels = int(vm["PYRAMID_LEVELS"])
    if "FUSED_PALLAS" in vm:
        p.fused_pallas = vm["FUSED_PALLAS"].strip().lower() in ("1", "true", "yes")
    if "INCREMENTAL_INV" in vm:
        p.incremental_inverse = vm["INCREMENTAL_INV"].strip().lower() in (
            "1", "true", "yes",
        )
    if "FINE_WINDOW" in vm:
        p.fine_window = int(vm["FINE_WINDOW"])
    if "STALL_WINDOW" in vm:
        p.stall_window = int(vm["STALL_WINDOW"])
    if "STALL_REL" in vm:
        p.stall_rel = float(vm["STALL_REL"])
    if "INNER_STEPS" in vm:
        p.inner_steps = int(vm["INNER_STEPS"])
    if "NEW_SURFACE_GATE" in vm:
        p.new_surface_gate = float(vm["NEW_SURFACE_GATE"])
    if "INV_MULTIGRID" in vm:
        p.inv_multigrid = vm["INV_MULTIGRID"].strip().lower() in (
            "1", "true", "yes",
        )

    vsx = p.voxel_sizes()[0]
    if "TSDF_TRUNC_DIST" in vm:
        p.tsdf_trunc_dist = float(vm["TSDF_TRUNC_DIST"]) * vsx
    if "ETA" in vm:
        p.eta = float(vm["ETA"]) * vsx

    t_z = float(vm.get("VOL_POSE_T_Z", 0.0))
    p.volume_pose = translation_pose(
        (-p.volume_size[0] / 2.0, -p.volume_size[1] / 2.0, t_z)
    )
    return p
