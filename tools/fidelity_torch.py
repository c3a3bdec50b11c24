"""Fidelity harness of the PyTorch port: the analytic scenes, oracles,
budgets and JSON report of tools/fidelity.py, run on sobfu_tpu_torch.

Five scenes, each with an exact surface oracle:

  * sphere translation (2.5 voxels), sphere expansion, dumbbell rotation
    (10 degrees) and a bending 5-sphere chain (12 degrees at the tip): one
    solve each, measuring the mesh RMSE of the warped live volume against
    the analytic surface, the data-energy ratio through the solve, and for
    the translation the psi o psi_inv residual;
  * 10 frames of constant x-drift through SobFusion's no-log frame loop
    (the CLI's without --enable-log): the accumulated
    deformation's tracking fraction on the surface band and the canonical
    mesh's RMSE against the start-pose sphere.

The budgets (:func:`budgets`) are tools/fidelity.py's, scaled by dim / 64
above 64^3; :func:`gate` is its pass rule. Runs on the card (--device
cuda, the default; no card is an error, never a move to the CPU) or on the
port's plain torch path (--device cpu). Imports nothing of JAX.

Usage: python tools/fidelity_torch.py [--dim 64] [--iters 512] [--device cuda|cpu]
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from sobfu_tpu_torch import core, fields, mc, solver
from sobfu_tpu_torch.config import Params, translation_pose
from sobfu_tpu_torch.ops import kernels
from sobfu_tpu_torch.tsdf import TsdfVolume, init_sphere


@dataclasses.dataclass(frozen=True)
class Lane:
    """Where and how the scenes solve: the device, --production (the full
    production configuration) and --fused (its accelerator dispatch)."""

    device: torch.device
    production: bool = False
    fused: bool = False


def make_params(dim, size, iters, alpha=0.1, w_reg=0.4):
    p = Params()
    p.volume_dims = (dim, dim, dim)
    p.volume_size = (size, size, size)
    p.tsdf_trunc_dist = 10.0 * size / dim
    p.eta = 2.0 * size / dim
    p.max_iter = iters
    p.max_update_norm = -1.0
    p.alpha = alpha
    p.w_reg = w_reg
    return p


def solve(p, phi_global, phi_n, warp_window, lane, momentum=0.9):
    """One solve from the identity. The default lane runs the additive solve
    with heavy-ball momentum and the cold 48-step inverse. --production runs
    solver.production_pyramid_kwargs as a cold single solve (no previous
    frame: 48 inverse steps, psi_inv at full resolution), at most two levels;
    without --fused its multigrid inverse is off and its coarse levels run
    kernel A, as tools/fidelity.py configures the JAX package without its
    fused kernels."""
    taps = solver.sobolev_filter_1d(p.s, p.lambda_)
    psi = fields.identity_field(phi_global.dims_zyx, device=lane.device)
    fused = lane.fused and warp_window is not None
    if lane.production:
        dim = phi_global.dims_zyx[0]
        kw = solver.production_pyramid_kwargs(dim, warm=False, no_log=False)
        kw["levels"] = min(kw["levels"], 2)  # fidelity grids are <= 128^3
        if warp_window is not None:
            kw["warp_window"] = warp_window
        if not fused:
            kw.update(fused=False, inv_multigrid=False, inv_coarse=False)
        else:
            kw["inv_multigrid"] = kw["inv_multigrid"] and dim >= 64
        return solver.estimate_psi_pyramid(
            psi, phi_global.tsdf, phi_global.weight, phi_n.tsdf, phi_n.weight, taps,
            p.alpha, p.w_reg, p.max_iter, 4e-3 * dim / 128.0, **kw,
        )
    return solver.estimate_psi(
        psi, phi_global.tsdf, phi_global.weight, phi_n.tsdf, phi_n.weight, taps,
        p.alpha, p.w_reg, p.max_iter, p.max_update_norm,
        inverse_iters=48, warp_window=warp_window, momentum=momentum,
    )


def energy(tsdf_global, tsdf):
    return float(solver.data_energy(tsdf_global, tsdf))


def mesh_rmse_sphere(tsdf, weight, voxel_sizes, centre, radius):
    """RMSE of isosurface vertex distances from an analytic sphere."""
    m = mc.extract_mesh(tsdf, weight, voxel_sizes, flip_yz=False)
    if m.vertices.shape[0] == 0:
        return float("nan"), 0
    d = np.linalg.norm(m.vertices - np.asarray(centre), axis=1) - radius
    return float(np.sqrt(np.mean(d * d))), int(m.n_triangles)


def scenario_sphere_translation(dim, iters, warp_window, lane):
    size = 0.25 * dim / 64
    # w_reg at the reference's low end (params_umbrella.ini W_REG=0.1): the
    # Sobolev-regularised flow equilibrates ~1 voxel short of a rigid
    # 2.5-voxel shift at w_reg=0.4
    p = make_params(dim, size, iters, alpha=0.1, w_reg=0.1)
    c0 = (size / 2, size / 2, size / 2)
    shift = 2.5 * size / dim  # 2.5 voxels
    c1 = (c0[0] - shift, c0[1], c0[2])
    r = 0.04 * size / 0.25

    phi_g = TsdfVolume(p, lane.device)
    phi_g.init_sphere(c0, r)
    phi_n = TsdfVolume(p, lane.device)
    phi_n.init_sphere(c1, r)

    e0 = energy(phi_g.tsdf, phi_n.tsdf)
    res = solve(p, phi_g, phi_n, warp_window, lane)
    e1 = energy(phi_g.tsdf, res.tsdf_n_psi)

    rmse, ntri = mesh_rmse_sphere(res.tsdf_n_psi, res.weight_n_psi, p.voxel_sizes(), c0, r)

    # psi o psi_inv - id: the displacement of psi sampled at psi_inv (kernel
    # B on three channels on the card, the window sampler on the CPU)
    comp = kernels.warp_field3(
        fields.displacement(res.psi), res.psi_inv, 4
    ) + fields.displacement(res.psi_inv)
    inner = comp.cpu().numpy()[:, 4:-4, 4:-4, 4:-4]

    return {
        "scenario": "sphere_translation_2.5vox",
        "dim": dim,
        "iters_run": int(res.iters),
        "energy_before": e0,
        "energy_after": e1,
        "energy_ratio": e1 / e0 if e0 else None,
        "mesh_rmse_m": rmse,
        "mesh_rmse_voxels": rmse / (size / dim),
        "triangles": ntri,
        "inverse_consistency_max_vox": float(np.abs(inner).max()),
    }


def scenario_sphere_expansion(dim, iters, warp_window, lane):
    size = 0.25 * dim / 64
    p = make_params(dim, size, iters, alpha=0.05, w_reg=0.2)
    c = (size / 2, size / 2, size / 2)
    r0, r1 = 0.04 * size / 0.25, 0.05 * size / 0.25

    phi_g = TsdfVolume(p, lane.device)
    phi_g.init_sphere(c, r0)
    phi_n = TsdfVolume(p, lane.device)
    phi_n.init_sphere(c, r1)

    e0 = energy(phi_g.tsdf, phi_n.tsdf)
    res = solve(p, phi_g, phi_n, warp_window, lane)
    e1 = energy(phi_g.tsdf, res.tsdf_n_psi)
    rmse, ntri = mesh_rmse_sphere(res.tsdf_n_psi, res.weight_n_psi, p.voxel_sizes(), c, r0)
    return {
        "scenario": "sphere_expansion",
        "dim": dim,
        "iters_run": int(res.iters),
        "energy_before": e0,
        "energy_after": e1,
        "energy_ratio": e1 / e0 if e0 else None,
        "mesh_rmse_m": rmse,
        "mesh_rmse_voxels": rmse / (size / dim),
        "triangles": ntri,
    }


class _Volume:
    """A (tsdf, weight) pair with the grid's extent, as solve() reads it."""

    def __init__(self, tsdf, weight):
        self.tsdf, self.weight = tsdf, weight
        self.dims_zyx = tuple(tsdf.shape)


def scenario_dumbbell_rotation(dim, iters, warp_window, lane):
    """Rigid rotation of a two-sphere dumbbell about the volume centre:
    rotational (non-axis-aligned, spatially varying) deformation."""
    size = 0.25 * dim / 64
    vs = size / dim
    p = make_params(dim, size, iters, alpha=0.1, w_reg=0.2)
    c = size / 2
    off = 6.0 * vs  # sphere centres +-6 voxels from volume centre
    r = 3.5 * vs
    theta = np.deg2rad(10.0)  # ~1 voxel of arc displacement at the centres

    def dumbbell(angle):
        ca, sa = np.cos(angle), np.sin(angle)
        c1 = (c + off * ca, c + off * sa, c)
        c2 = (c - off * ca, c - off * sa, c)
        t1, w1 = init_sphere((dim,) * 3, (vs,) * 3, c1, r, p.tsdf_trunc_dist, p.eta,
                             device=lane.device)
        t2, w2 = init_sphere((dim,) * 3, (vs,) * 3, c2, r, p.tsdf_trunc_dist, p.eta,
                             device=lane.device)
        # analytic union of solids: min of signed distances
        return torch.minimum(t1, t2), torch.maximum(w1, w2), (c1, c2)

    tg, wg, (g1, g2) = dumbbell(0.0)
    tn, wn, _ = dumbbell(theta)

    e0 = energy(tg, tn)
    res = solve(p, _Volume(tg, wg), _Volume(tn, wn), warp_window, lane)
    e1 = energy(tg, res.tsdf_n_psi)

    m = mc.extract_mesh(res.tsdf_n_psi, res.weight_n_psi, (vs,) * 3, flip_yz=False)
    if m.vertices.shape[0]:
        d1 = np.linalg.norm(m.vertices - np.asarray(g1), axis=1) - r
        d2 = np.linalg.norm(m.vertices - np.asarray(g2), axis=1) - r
        d = np.minimum(np.abs(d1), np.abs(d2))
        rmse = float(np.sqrt(np.mean(d * d)))
    else:
        rmse = float("nan")
    return {
        "scenario": "dumbbell_rotation_10deg",
        "dim": dim,
        "iters_run": int(res.iters),
        "energy_before": e0,
        "energy_after": e1,
        "energy_ratio": e1 / e0 if e0 else None,
        "mesh_rmse_m": rmse,
        "mesh_rmse_voxels": rmse / vs,
        "triangles": int(m.n_triangles),
    }


def scenario_bending_chain(dim, iters, warp_window, lane):
    """Articulated deformation: a 5-sphere chain anchored at one end bends
    about the anchor, each link rotating further (angle proportional to arc
    position): the anchor static, the free end ~2.5 voxels away. The union
    of spheres is the surface oracle."""
    size = 0.25 * dim / 64
    vs = size / dim
    p = make_params(dim, size, iters, alpha=0.1, w_reg=0.2)
    c = size / 2
    n_links = 5
    spacing = 3.2 * vs
    r = 2.8 * vs
    theta_tip = np.deg2rad(12.0)  # free-end rotation; tip arc ~2.7 voxels

    def chain(bend):
        # anchor at (c - 2*spacing, c, c); link i at arc distance i*spacing,
        # rotated about the anchor by bend * i / (n_links - 1) in the xy plane
        anchor = np.array([c - 2.0 * spacing, c, c])
        tsdf = weight = None
        centres = []
        for i in range(n_links):
            a = bend * i / (n_links - 1)
            d = i * spacing
            ci = anchor + np.array([d * np.cos(a), d * np.sin(a), 0.0])
            t, w = init_sphere((dim,) * 3, (vs,) * 3, tuple(ci), r, p.tsdf_trunc_dist, p.eta,
                               device=lane.device)
            # union of solids
            tsdf = t if tsdf is None else torch.minimum(tsdf, t)
            weight = w if weight is None else torch.maximum(weight, w)
            centres.append(ci)
        return tsdf, weight, centres

    tg, wg, gc = chain(0.0)
    tn, wn, _ = chain(theta_tip)

    e0 = energy(tg, tn)
    res = solve(p, _Volume(tg, wg), _Volume(tn, wn), warp_window, lane)
    e1 = energy(tg, res.tsdf_n_psi)

    m = mc.extract_mesh(res.tsdf_n_psi, res.weight_n_psi, (vs,) * 3, flip_yz=False)
    if m.vertices.shape[0]:
        d = np.full(m.vertices.shape[0], np.inf)
        for ci in gc:
            d = np.minimum(d, np.abs(np.linalg.norm(m.vertices - ci, axis=1) - r))
        rmse = float(np.sqrt(np.mean(d * d)))
    else:
        rmse = float("nan")
    return {
        "scenario": "bending_chain_12deg",
        "dim": dim,
        "iters_run": int(res.iters),
        "energy_before": e0,
        "energy_after": e1,
        "energy_ratio": e1 / e0 if e0 else None,
        "mesh_rmse_m": rmse,
        "mesh_rmse_voxels": rmse / vs,
        "triangles": int(m.n_triangles),
    }


def scenario_multiframe_accumulation(dim, iters, warp_window, lane, n_frames=10):
    """n_frames of constant x-drift through SobFusion: (a) the accumulated
    deformation tracks the ground-truth cumulative displacement on the
    surface band and (b) the canonical model stays on the analytic
    start-pose surface (drift would smear it)."""
    from sobfu_tpu_torch.pipeline import SobFusion

    size = 0.25 * dim / 64
    vs = size / dim
    p = make_params(dim, size, iters, alpha=0.15, w_reg=0.2)
    p.momentum = 0.9
    p.warp_window = warp_window or 4
    if lane.production:
        # the production pipeline across the frame sequence: the additive
        # fine level and the warm inverse carried from frame to frame
        p.momentum = 0.95
        p.pyramid_levels = 2
        p.fine_window = None
        p.stall_window = 16
        p.stall_rel = 1e-2
        p.max_update_norm = 4e-3 * dim / 128.0
        p.inverse_iters = 3
    p.intr = type(p.intr)(fx=70.0 * dim / 64, fy=70.0 * dim / 64, cx=47.5, cy=35.5)
    p.bilateral_kernel_size = 5
    p.start_frame = 1
    H, W = 72, 96

    r = 0.08 * size / 0.25
    z_cam = 0.45 * size / 0.25
    # volume centred on the sphere, camera at the origin looking +z
    p.volume_pose = translation_pose((-size / 2, -size / 2, z_cam - size / 2))
    drift_vox_per_frame = 0.25
    drift = drift_vox_per_frame * vs

    def render_depth(cx):
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        dx = (xx - p.intr.cx) / p.intr.fx
        dy = (yy - p.intr.cy) / p.intr.fy
        # ray-sphere for a sphere at (cx, 0, z_cam) in camera coords
        ox, oy = -cx, 0.0
        b = dx * ox + dy * oy - z_cam
        c0 = ox * ox + oy * oy + z_cam * z_cam - r * r
        a = dx * dx + dy * dy + 1.0
        disc = b * b - a * c0
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        depth = np.where(disc > 0, t * 1000.0, 0.0)  # mm
        return depth.astype(np.uint16)

    fusion = SobFusion(p, lane.device)
    # the frame loop as the CLI runs it without --enable-log: psi_inv is a
    # warm start only and the fuse floor-warps the live weight itself
    # (kernel D on the card). The scene's psi and canonical volume are those
    # of the logged loop that tools/fidelity.py runs.
    fusion.need_inv_warps = False
    for i in range(n_frames):
        fusion(render_depth(drift * i))

    total_vox = drift * (n_frames - 1) / vs
    disp = fields.displacement(fusion.psi.data).cpu().numpy()
    tsdf_g = fusion.phi_global.tsdf.cpu().numpy()
    band = (np.abs(tsdf_g) < 0.5) & (fusion.phi_global.weight.cpu().numpy() > 0)
    mean_dx = float(disp[0][band].mean()) if band.sum() else float("nan")

    # the canonical model must still sit on the frame-0 sphere
    centre_world = (0.0, 0.0, z_cam)  # camera frame == world (identity pose)
    m = mc.extract_mesh(
        fusion.phi_global.tsdf, fusion.phi_global.weight, p.voxel_sizes(),
        pose=fusion.phi_global.pose, flip_yz=False,
    )
    if m.vertices.shape[0]:
        d = np.linalg.norm(m.vertices - np.asarray(centre_world), axis=1) - r
        rmse = float(np.sqrt(np.mean(d * d)))
    else:
        rmse = float("nan")
    return {
        "scenario": f"accumulated_drift_{n_frames}frames",
        "dim": dim,
        "frames": n_frames,
        "ground_truth_drift_vox": total_vox,
        "tracked_mean_dx_vox": mean_dx,
        "tracking_fraction": mean_dx / total_vox if total_vox else None,
        "mesh_rmse_m": rmse,
        "mesh_rmse_voxels": rmse / vs,
        "triangles": int(m.n_triangles),
        # keys shared with the solver scenarios for the uniform gate
        "energy_ratio": 0.0,
    }


# the tracking fraction's open interval (tools/fidelity.py:495)
TRACKING = (0.35, 1.5)


def budgets(dim, frames):
    """{scenario: (mesh RMSE bar in voxels, energy-ratio bar)}: the budgets
    of tools/fidelity.py:478-484. Translation sub-half-voxel, the rest
    sub-voxel, calibrated at 64^3; above it the voxel bars scale with
    dim / 64, so the bar stays the same metric accuracy."""
    rs = max(1.0, dim / 64.0)
    return {
        "sphere_translation_2.5vox": (0.5 * rs, 0.30),
        "sphere_expansion": (1.0 * rs, 0.55),
        "dumbbell_rotation_10deg": (1.0 * rs, 0.60),
        "bending_chain_12deg": (1.0 * rs, 0.60),
        f"accumulated_drift_{frames}frames": (1.0 * rs, 1.0),
    }


def gate(results, dim, frames) -> bool:
    """tools/fidelity.py's pass rule: every result's energy ratio at or under
    its bar, its mesh RMSE finite and under its bar, and a tracking fraction,
    where there is one, inside TRACKING."""
    table = budgets(dim, frames)
    ok = True
    for r in results:
        rmse_bar, e_bar = table.get(r["scenario"], (1.0, 0.5))
        ok &= r["energy_ratio"] is not None and r["energy_ratio"] <= e_bar
        ok &= bool(np.isfinite(r["mesh_rmse_voxels"]) and r["mesh_rmse_voxels"] < rmse_bar)
        if "tracking_fraction" in r:
            ok &= r["tracking_fraction"] is not None
            ok &= bool(TRACKING[0] < r["tracking_fraction"] < TRACKING[1])
    return bool(ok)


SCENARIOS = ("translation", "expansion", "rotation", "bending", "accumulation")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--iters", type=int, default=512)
    ap.add_argument("--warp-window", type=int, default=None)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--fused", action="store_true",
                    help="the production lane's accelerator dispatch: kernel E on a 64^3 "
                    "coarse level and the multigrid inverse at dim >= 64")
    ap.add_argument("--production", action="store_true",
                    help="run the full production config (pyramid + momentum .95 + 4e-3 "
                    "stop + stall net) through the same quality gates")
    ap.add_argument("--scenarios", default="all",
                    help="comma list from " + ",".join(SCENARIOS) + " (default all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card (default; no card is an error) or the plain torch path")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The scenes named by args, then the gate: {"results": [...], "pass": bool}."""
    lane = Lane(core.resolve_device(args.device), args.production, args.fused)
    runners = {
        "translation": lambda: scenario_sphere_translation(
            args.dim, args.iters, args.warp_window, lane),
        "expansion": lambda: scenario_sphere_expansion(
            args.dim, args.iters, args.warp_window, lane),
        "rotation": lambda: scenario_dumbbell_rotation(
            args.dim, args.iters, args.warp_window, lane),
        "bending": lambda: scenario_bending_chain(
            args.dim, args.iters, args.warp_window, lane),
        "accumulation": lambda: scenario_multiframe_accumulation(
            args.dim, max(96, args.iters // 4), args.warp_window, lane,
            n_frames=args.frames),
    }
    wanted = (
        list(runners) if args.scenarios == "all"
        else [s.strip() for s in args.scenarios.split(",") if s.strip()]
    )
    report = {"results": [runners[name]() for name in wanted]}
    report["pass"] = gate(report["results"], args.dim, args.frames)
    return report


def main(argv=None):
    report = run(parse_args(argv))
    print(json.dumps(report, indent=2))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
