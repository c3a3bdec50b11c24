#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sobfu_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the result lines:
  1. device    nvidia-smi name and power limit, torch / CUDA versions
  2. build     the four kernels from sobfu_tpu_torch/csrc with nvcc
  3. kernels   each kernel against its plain torch version on the same
               CUDA tensors at the slice's shapes (128^3, 7 taps, K=2 and
               the exact mode): atol 1e-5, bitwise for the floor warp and
               the fuse; median times from CUDA events after a warm-up
  4. goldens   the solver on the card against tests/golden/solver_16*.npz
               (atol 1e-5, the JAX package's frozen CPU results)
  5. main path params/params_umbrella.ini + WARP_WINDOW=2: 4 frames of
               640x480 depth (a translating sphere, rendered in memory)
               through SobFusion(device="cuda") with MAX_ITER=2048, then the
               phi_global mesh; every kernel must have launched
  6. shipped   params_umbrella.ini unchanged (exact mode): 2 frames
The last three lines are the kernel report (JSON), the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
DIM = 128
TAPS, LAMBDA = 7, 0.1


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def render_prims_depth():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_scene", os.path.join(ROOT, "tools", "make_synthetic_scene.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render_prims_depth


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() over reps runs, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_abs(a, b) -> float:
    import torch

    if a is None and b is None:
        return 0.0
    return float(torch.max(torch.abs(a - b)))


def bitwise(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def check_kernels(torch, kernels, fields, solver):
    """Phase 3: returns {name: (max_abs_err, ms, plain_ms)} at K=2."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    dims = (DIM, DIM, DIM)
    vs = 1.0 / DIM

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    from sobfu_tpu_torch.tsdf import init_sphere

    tg, _ = init_sphere(dims, (vs,) * 3, (0.5, 0.5, 0.5), 0.2, 8 * vs, 3 * vs, device=dev)
    live, _ = init_sphere(dims, (vs,) * 3, (0.49, 0.5, 0.5), 0.2, 8 * vs, 3 * vs, device=dev)
    ident = fields.identity_field(dims, device=dev)
    psi_w = ident + t(rng.uniform(-1.8, 1.8, (3,) + dims))   # inside the K=2 window
    psi_x = ident + t(rng.uniform(-3.5, 3.5, (3,) + dims))   # beyond it (exact mode)
    tnp = live + t(rng.normal(0.0, 0.05, dims))
    vel = t(rng.normal(0.0, 1.0, (3,) + dims))
    wgc = t(rng.integers(0, 4, dims).astype(np.float32))      # weights 0..3
    wnc = t(rng.integers(0, 2, dims).astype(np.float32))
    taps = torch.as_tensor(solver.sobolev_filter_1d(TAPS, LAMBDA), device=dev)
    alpha, w_reg = 0.05, 0.2
    results = {}

    # A: gd_iteration
    errs = []
    for K, psi, mu in ((2, psi_w, None), (2, psi_w, 0.9), (None, psi_x, None)):
        args = (psi, tnp, vel, tg, live, taps, alpha, w_reg, mu, K)
        got = kernels.gd_iteration(*args)
        ref = kernels.gd_iteration_plain(*args)
        e = max(max_abs(g, r) for g, r in zip(got[:3], ref[:3]))
        e_norm = abs(float(got[3]) - float(ref[3])) / max(float(ref[3]), 1e-30)
        log("kernels", f"gd_iteration K={K} momentum={mu}: max|d|={e:.3e} "
            f"rel d(max_sq)={e_norm:.3e}")
        check(e <= 1e-5 and e_norm <= 1e-5, "gd_iteration disagrees with its plain version")
        errs.append(e)
    args = (psi_w, tnp, vel, tg, live, taps, alpha, w_reg, None, 2)
    ms = cuda_ms(lambda: kernels.gd_iteration(*args), 50)
    plain = cuda_ms(lambda: kernels.gd_iteration_plain(*args), 10)
    results["gd_iteration"] = (max(errs), ms, plain)

    # B: warp (trilinear, floor, mixed)
    errs = []
    for K, psi in ((2, psi_w), (None, psi_x)):
        for floor in ((False,), (True,), (False, True)):
            vol = torch.stack([tg, wgc])[: len(floor)].contiguous()
            got = kernels.warp(vol, psi, K, floor)
            ref = kernels.warp_plain(vol, psi, K, floor)
            e = max_abs(got, ref)
            exact_ch = [c for c in range(len(floor)) if floor[c]]
            bit = all(bitwise(got[c], ref[c]) for c in exact_ch)
            log("kernels", f"warp K={K} floor={floor}: max|d|={e:.3e} floor bitwise={bit}")
            check(e <= 1e-5 and bit, "warp disagrees with its plain version")
            errs.append(e)
    vol1 = tg[None].contiguous()
    ms = cuda_ms(lambda: kernels.warp(vol1, psi_w, 2, (False,)), 50)
    plain = cuda_ms(lambda: kernels.warp_plain(vol1, psi_w, 2, (False,)), 10)
    results["warp"] = (max(errs), ms, plain)

    # C: inverse fixed point (warm 3 steps in the window, 48 exact from identity)
    errs = []
    psi_small = ident + t(rng.uniform(-0.9, 0.9, (3,) + dims))
    warm = kernels.inverse_fixed_point_plain(psi_small, 2, 2)
    for K, iters, init in ((2, 3, warm), (2, 3, None), (None, 48, None)):
        got = kernels.inverse_fixed_point(psi_small, iters, K, init)
        ref = kernels.inverse_fixed_point_plain(psi_small, iters, K, init)
        e = max_abs(got, ref)
        log("kernels", f"inverse_fixed_point K={K} iters={iters} "
            f"warm={init is not None}: max|d|={e:.3e}")
        check(e <= 1e-5, "inverse_fixed_point disagrees with its plain version")
        errs.append(e)
    ms = cuda_ms(lambda: kernels.inverse_fixed_point(psi_small, 3, 2, warm), 50)
    plain = cuda_ms(lambda: kernels.inverse_fixed_point_plain(psi_small, 3, 2, warm), 10)
    results["inverse_fixed_point"] = (max(errs), ms, plain)

    # D: warp_fuse, bitwise
    errs = []
    tnp_q = torch.where(wnc > 0, tnp, 0.0).contiguous()
    for K, psi in ((2, psi_w), (None, psi_x)):
        args = (tg, wgc, tnp_q, wnc, psi, 128.0, K)
        got = kernels.warp_fuse(*args)
        ref = kernels.warp_fuse_plain(*args)
        bit = bitwise(got[0], ref[0]) and bitwise(got[1], ref[1])
        e = max(max_abs(got[0], ref[0]), max_abs(got[1], ref[1]))
        log("kernels", f"warp_fuse K={K}: max|d|={e:.3e} bitwise={bit}")
        check(bit, "warp_fuse is not bit-identical to its plain version")
        errs.append(e)
    args = (tg, wgc, tnp_q, wnc, psi_w, 128.0, 2)
    ms = cuda_ms(lambda: kernels.warp_fuse(*args), 50)
    plain = cuda_ms(lambda: kernels.warp_fuse_plain(*args), 10)
    results["warp_fuse"] = (max(errs), ms, plain)
    for name, (e, ms, plain) in results.items():
        log("kernels", f"{name}: {ms:.4f} ms kernel, {plain:.4f} ms plain (median, 128^3, K=2)")
    return results


def check_goldens(torch, fields, solver):
    """Phase 4: the 16^3 golden fixture of tests/test_golden.py on the card."""
    from sobfu_tpu_torch.tsdf import init_sphere

    dev = torch.device(DEVICE)
    dims = (16, 16, 16)
    vs = 0.25 / 16
    tg, wg = init_sphere(dims, (vs,) * 3, (0.125,) * 3, 0.04, 8 * vs, 3 * vs, device=dev)
    tn, wn = init_sphere(dims, (vs,) * 3, (0.118, 0.125, 0.125), 0.04, 8 * vs, 3 * vs,
                         device=dev)
    taps = solver.sobolev_filter_1d(7, 0.1)
    psi = fields.identity_field(dims, device=dev)
    for name, K in (("solver_16.npz", None), ("solver_16_window.npz", 2)):
        g = np.load(os.path.join(ROOT, "tests", "golden", name))
        res = solver.estimate_psi(psi, tg, wg, tn, wn, taps, 0.1, 0.3, 32, -1.0,
                                  inverse_iters=8, warp_window=K)
        e = max(
            float(np.abs(res.psi.cpu().numpy() - g["psi"]).max()),
            float(np.abs(res.tsdf_n_psi.cpu().numpy() - g["tnp"]).max()),
            float(np.abs(res.psi_inv.cpu().numpy() - g["psi_inv"]).max()),
        )
        log("goldens", f"{name}: max|d|={e:.3e} iters={res.iters}")
        check(e <= 1e-5 and res.iters == 32, f"{name}: port on the card disagrees")


def run_frames(torch, kernels, params, n_frames, phase):
    """Drive SobFusion on the card over n_frames of a translating sphere."""
    from sobfu_tpu_torch import mc
    from sobfu_tpu_torch.pipeline import SobFusion

    render = render_prims_depth()
    intr = params.intr
    H, W = params.rows, params.cols
    frames = [
        render(H, W, intr.fx, intr.fy, intr.cx, intr.cy, [((0.006 * i, 0.0, 0.8), 0.2)])
        for i in range(n_frames)
    ]
    fusion = SobFusion(params, device=DEVICE)
    fusion.need_inv_warps = False  # the no-log frame loop, as the CLI runs it
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for i, depth in enumerate(frames):
        t0 = time.perf_counter()
        fusion(depth)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res = fusion.last_solve if i >= max(1, params.start_frame) else None
        if res is None:
            log(phase, f"frame {i}: {dt:.4f} s (integrate only)")
        else:
            log(
                phase,
                f"frame {i}: {dt:.4f} s, iters {res.iters}, "
                f"{1000.0 * dt / max(res.iters, 1):.4f} ms/iter (frame time / iters), "
                f"final max-norm {res.max_norm:.6e}",
            )
    counts = dict(kernels.launch_counts)
    mesh = mc.extract_mesh(
        fusion.phi_global.tsdf, fusion.phi_global.weight,
        fusion.phi_global.voxel_sizes(), pose=fusion.phi_global.pose,
    )
    torch.cuda.synchronize()
    log(phase, f"launch counts {counts}; phi_global mesh {mesh.n_triangles} triangles")
    for name, n in counts.items():
        check(n > 0, f"{phase}: kernel {name} was never launched")
    state = (fusion.phi_global.tsdf, fusion.phi_global.weight, fusion.psi.data,
             fusion.psi_inv.data)
    check(all(bool(torch.isfinite(s).all()) for s in state), f"{phase}: non-finite state")
    dims = (3,) + fusion.phi_global.dims_zyx
    check(tuple(fusion.psi.data.shape) == dims, f"{phase}: psi shape")
    check(mesh.n_triangles > 0 and np.isfinite(mesh.vertices).all(), f"{phase}: empty mesh")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sobfu_tpu_torch import fields, solver
    from sobfu_tpu_torch.config import load_params
    from sobfu_tpu_torch.ops import _build, kernels

    smi = nvidia_smi()
    log("device", f"{smi} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    path, build_log = _build.build(verbose=True)
    _build.library()
    log("build", f"{time.perf_counter() - t0:.2f} s -> {os.path.relpath(path, ROOT)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("build", line.strip())

    results = check_kernels(torch, kernels, fields, solver)
    check_goldens(torch, fields, solver)

    params = load_params(os.path.join(ROOT, "params", "params_umbrella.ini"))
    params.warp_window = 2
    counts = run_frames(torch, kernels, params, 4, "main")

    shipped = load_params(os.path.join(ROOT, "params", "params_umbrella.ini"))
    run_frames(torch, kernels, shipped, 2, "shipped")
    torch.cuda.synchronize()

    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": kernels.KERNELS[name][0],
            "replaces": kernels.KERNELS[name][1],
            "launches": counts[name],
            "max_abs_err": results[name][0],
            "ms": results[name][1],
            "plain_ms": results[name][2],
        }
        for name in kernels.launch_counts
    ]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
