#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sobfu_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the result lines:
  1. device     nvidia-smi name and power limit, torch / CUDA versions
  2. build      the eight kernel sources of sobfu_tpu_torch/csrc, one nvcc
                per source, all started together
  3. kernels    each kernel against its plain torch version on the same
                CUDA tensors at the path's shapes (A-D at 128^3, 7 taps,
                K=2 and the exact mode; A's stall energy, rtol 1e-5; E at
                the coarse level's 64^3, K=1, momentum 0.95, 16 iterations,
                with and without the verbose rows, and its loop (kernels.
                GdMultiLoop: 8 launches a host read, the stop test on the
                card) bit for bit against one launch a chunk with a norm
                stop inside a chunk, a cap of 40 and a stall stop; C at
                128^3, K=2, 3 warm steps, at 64^3, K=1, 3 warm steps and at
                128^3, 48 exact steps; F at 128^3 with Kf=1,
                Kw=2 and Kf=2, Kw=2; B on three channels, warp_field3, at
                128^3, exact and K = 1, 2, 4, at the noise fields and at
                smooth ones (smooth_displacement): bit for bit with its plain
                version and with three one-channel B launches): atol 1e-5,
                bitwise for the floor warp, the fuse and F, and E bit for
                bit against 16 chained A launches; A over four scenes (see
                11); A also on (12, 16, 20), 16^3 and 64^3 with 3 to 11
                taps; the chunked loop (kernels.GdLoop: 16 iterations per
                call, the stop test on the card) bit for bit against single
                launches, with a norm stop inside a chunk and a scene
                frozen from the start. Two times per kernel: ms, one CUDA
                event pair around a run of 20 calls (median of 7 runs), and
                device_ms, torch.profiler's device time per call; A's rows
                through the chunked loop, per iteration. B's exact warp in
                turns with torch.nn.functional.grid_sample on the same
                inputs (B, library, library, B) at +-1.8 and +-3.5 voxels;
                warp_field3 so in turns with grid_sample exact at psi_x
                (+-3.5 voxels of noise) and at a smooth field of 3.5 voxels,
                K=2 at psi_w and at a smooth field of 1.95, and after phase
                9 exact and K=2 on its last composition's operands
 3b. frontend  the front end's kernels (ops/frontend.py) against their
                plain versions on the card: P (preprocess_depth: the
                bilateral filter, the truncation and the ray lengths) at the
                ini's 640x480 with k = 7, 5, 3, truncation on and off, and at
                479x637, bit for bit; I (integrate_dists) at 128^3 on the
                axis-aligned pose, a z-slab (z_offset 64) and over 1.2 m (a
                voxel size that is no power of two), bit for bit, and
                on a pose turned 4 degrees about y and 2 about x (voxels that
                read another pixel counted, at most 64; the rest within
                1e-6); first how torch rounds addcmul and the einsum on the
                card. Each kernel's ms, device_ms, bound and plain ms
  4. goldens    the solver on the card against tests/golden/solver_16*.npz
                (atol 1e-5, the JAX package's frozen CPU results), the
                pyramid and compositive goldens included
  5. main       params/params_umbrella.ini + WARP_WINDOW=2: 4 frames of
                640x480 depth (a translating sphere, rendered in memory)
                through SobFusion(device="cuda") with MAX_ITER=2048, then
                the phi_global mesh; kernels A-D must have launched, and P
                and I (frontend.launch_counts) in every phase that drives
                SobFusion (5-10)
  6. shipped    params_umbrella.ini unchanged (exact mode): 2 frames
  7. pyramid    the slice: umbrella + the production keys (WARP_WINDOW=2,
                MOMENTUM=0.95, ALPHA=0.05, PYRAMID_LEVELS=2, MAX_ITER=1024,
                MAX_UPDATE_NORM=4e-3, STALL_WINDOW=16, STALL_REL=1e-2; the
                multigrid inverse with the half-res carry) at 128^3, 4
                frames; per frame the wall time, coarse and fine iterations,
                the host reads of the solve loops (kernel A's: one per chunk
                of 16 iterations or stall check, not one per iteration: at
                most MAX_ITER / 16 + 2 per level; kernel E's: one per 8
                chunks of 16; or the phase fails), E's share of them,
                why the fine level stopped, and each level's solve timed on
                its own (ms per iteration); all five kernels must have
                launched (E on the 64^3 coarse level), psi_inv is carried
                half-res and the psi_inv mesh getter materialises it full-res
  8. pyramid256 the same keys at 256^3 with PYRAMID_LEVELS=3: 2 frames
  9. compositive umbrella + SOLVER_MODE=compositive, WARP_WINDOW=2,
                MOMENTUM=0.9, ALPHA=0.05, PYRAMID_LEVELS=2, MAX_ITER=1024,
                MAX_UPDATE_NORM=4e-3, STALL_WINDOW=16, STALL_REL=1e-2 at
                128^3: 6 frames of a 0.05 m sphere translating 9 mm (1.15
                voxels) a frame, so the accumulated motion leaves the K=2
                window by frame 3; B (the exact T0 and weight warps), E (the 64^3
                increment level), A (the fine increment) and warp_field3
                (the composition) must launch; the band-mean x
                displacement must exceed 0.55 x the accumulated drift,
                which exceeds K + 1, and the band-mean y stay under 0.25 x
                it; then the psi_inv mesh getter must run C (the exact
                cold inverse) and B (the exact warps)
 10. fine_window the pyramid phase's keys + FINE_WINDOW=1 (the ini that
                tools/make_synthetic_scene.py --production writes) at
                128^3, 4 frames: E, B, A (the K=1 fine increment), F (the
                composition and the weight) and C (the multigrid inverse,
                carried half-res) must launch
 11. multiscene the scene-batched frame step (sobfu_tpu_torch.parallel.
                make_frame_step) in tools/bench_multiscene_stream.py's
                configuration at 128^3: its four scenes (spheres drifting
                +x, -x, +y, -y), 6 frames with psi, tg, wg and psi_inv
                carried, then scene 0 alone over the same frames; per
                frame the seconds, each scene's coarse and fine iterations
                and each level's batched loop; the scene-frames per second
                of both and the busy share of a profiled frame of each.
                A over scenes (gd_iteration_scenes), B, C and D must
                launch, A never unbatched; scene 0 of the batch must equal
                scene 0 alone bit for bit; every scene must track its own
                drift by the tool's criterion (:164-179), on the tool's
                band |tsdf| < 0.5 and on its observed part (weight > 0,
                the surface; most of the tool's band is free space with
                tsdf 0). Phase 3 holds
                gd_iteration_scenes at 128^3, S=4, K=2, momentum 0.95 with
                one scene inactive to its plain version and each scene to
                an unbatched A launch bit for bit, and times it against
                four unbatched A launches
 12. cli        sobfu_tpu_torch.cli.main in this process with --device cuda,
                on scenes written by tools/make_synthetic_scene.py to a
                temporary directory. (a) The production scene (--production:
                the sphere preset, 320x240, the pyramid keys and
                FINE_WINDOW=1) at 128^3, 6 frames: straight through with
                --enable-log --checkpoint A.npz, then --max-frames 3
                --checkpoint B.npz and --resume B.npz --checkpoint B.npz
                --enable-log; A.npz and B.npz must agree key for key and bit
                for bit, the resumed run must say "resumed at frame 3", its
                last logged mesh and field (read back with the port's
                loaders) must equal the straight run's, psi_inv must be
                carried at full resolution (the ini has no key for the
                half-res carry) and E, B, A, F and C must launch; per frame
                the CLI's seconds, the checkpoint's save seconds and bytes,
                and the decode milliseconds on the Python thread and through
                the native prefetch loader (where its library builds; the
                Python decoder must not run where it does). Then the
                fine_window phase's params (Solver.inv_coarse) through
                SobFusion and the checkpoint module: 3 + save + load + 3
                frames bit for bit against 6 straight with psi_inv half-res,
                the save and load seconds and bytes. (b) The same scene, 2
                frames, with --enable-log --color-mesh --live-viz
                --live-viz-port 0, and --enable-viz-detailed where
                matplotlib imports: the logged mesh carries colours,
                /state.json serves the panels, kernel C runs at full
                resolution (the inverse warps are on) and the screenshot
                exists. (c) tools/validate_torch_cli_scene.py on the
                articulated scene, 20 frames at 64^3 (the preset's
                compositive keys and NEW_SURFACE_GATE): every frame inside
                2.2 voxels canonical and 1.5 voxels live RMSE; the curves
                are printed
 13. sharded    the z-sharded path (sobfu_tpu_torch.parallel.zshard) on
                meshes that name the card several times. (a) Kernel A's slab
                form (gd_iteration_slab) on CUDA tensors, each slab against
                its plain version (atol 1e-5) and against the whole-volume A
                launch bit for bit: 128^3, 7 taps, K=2, momentum 0.95 in 2,
                4 and 8 slabs (halos cut by _halo_exchange_z), 64^3 exact
                (live whole) and K=1 in 4, (12, 16, 20) in 2; the loop
                (kernels.GdSlabLoop) at 128^3 in 2, 4 and 8 slabs of the
                card, as one card group and forced into one group a slab,
                bit for bit with GdLoop on the whole volume (iterations,
                norm rows, psi, tnp, vel; the energy per slab, bit for bit
                between the two layouts, rtol 1e-5 from GdLoop's), one
                launch per group and iteration; the times at 128^3 / 4
                slabs of an iteration of the loop in both layouts, of one
                slab a call and of the whole-volume A through GdLoop, with
                the loop's kernel calls an iteration. (b)
                make_sharded_estimate_psi on make_mesh(n_z=4) at 128^3,
                fused, momentum 0.9, warm inverse, K=2, 40 iterations,
                against solver.estimate_psi: equal iterations, psi and tnp
                within 2e-5, the max norm within rtol 1e-4, |d psi_inv| <=
                0.05; pyramid_levels=2
                against estimate_psi_pyramid (coarse cap 12): fine
                iterations within max(4, 15%), energy <= 1.05x; fine_window=1
                against estimate_psi_compositive (psi within 8 ulps of the
                largest coordinate). (c) make_frame_step over a (2 scene x 4
                z) mesh at 64^3, 4 scenes, 8 iterations, against the
                one-device step: within 1e-5 in __graft_entry__.py's parity
                configuration (one level), the dry-run configuration's seams
                printed; then 256^3, 2 drifting spheres, 3 frames (seconds,
                iterations, host reads, halo bytes per iteration, a
                profiled frame's busy share and the slab form's device
                time in it, peak memory). (d) one 512^3 frame on
                make_mesh(n_z=8), MAX_ITER 32 a level: its seconds, 0
                whole-volume gathers, peak memory. Only A's slab form may
                launch on these paths
 14. kinfu      models.KinFu at KinFuParams.default_params() (640x480,
                512^3), frame-to-frame and frame-to-model (run_kinfu_phase)
 15. fidelity   tools/fidelity_torch.py in this process on the card, in six
                lanes (FIDELITY_LANES): the JAX package's three CI lanes
                with their flags, the tool's defaults at 64^3, --production
                at 64^3, and --production --fused at 128^3 (E on the 64^3
                coarse level, the multigrid inverse); each lane's JSON
                report, seconds and launches beside the nvidia-smi line.
                Every lane must pass tools/fidelity.py's budgets and launch
                A, B and C; D where the accumulation scene runs, E in the
                fused lane. Then each kernel at each signature the lane ran
                (grid, window, channels, steps) against its plain version
                on the card: B, warp_field3 and C on the lane's own operands
                (atol 1e-5), D bit for bit, A and E on its volumes and taps
                at a psi drawn around the identity. The two 32^3 lanes (and
                under --fidelity the 64^3 lane's four solver scenes) run
                again on the CPU: equal iterations, the report's figures
                within 1e-4
 16. logged     the compositive loop with the inverse warps on at 32^3, 4
                frames, on the card and on the CPU: the incremental inverse
                and the exact tails; psi and psi_inv within 8 ulps of the
                largest coordinate, the tails against B's plain version
 17. bench      bench_torch.main in this process on the card (every
                cell at bench.py's grids, counts and repeats), its JSON
                line printed tagged [bench]: no cell may fail, every
                top-level figure is set and finite (a null leaf only with
                its reason), every convergence cell ran iterations with a
                finite e_ratio, and A, E, B, C, D and warp_field3 launched;
                then tools/bench_multiscene_stream_torch.py (64^3, 6
                frames: A over scenes must launch, every scene must track
                its drift) and tools/check_inverse_multigrid_torch.py
                (256^3: every row's two figures finite), each tool's JSON
                line printed tagged [bench]
The launch counts of each path are zeroed just before it and read just
after; kernel A's count is the iterations that ran on the card (the
device's counter), its launches after a stop are printed apart. Before the
last three lines, the front end's line: {"frontend": [...]}, P and I with
the kernel report's keys, their launches summed over phases 5-10 ("replaces"
names the JAX package's XLA function: neither has a TPU kernel). The last
three lines are the kernel report (JSON; launches summed over the paths
above that run each kernel; each kernel's ms and device_ms, its plain
version's time, the bound of its work at the shapes timed — the bytes it
must move at 3.35 TB/s or its float operations at 67 TFLOP/s, whichever is
larger — and, for B's exact warp and warp_field3,
torch.nn.functional.grid_sample's time; B's row carries its K=2 and mixed
C=2 variants under "also", warp_field3's (exact at psi_x) its rows at the
smooth fields, at psi_w and on a real composition), the
nvidia-smi line and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --kernels

stops after phase 4 (the build, the kernel checks, the front end, the
goldens).

    python3 chip_smoke.py --sharded

runs the build and phase 13 alone; --kinfu phase 14, --fidelity phases 15
and 16 (phase 15's CPU half at 64^3 too), --bench phase 17.

    python3 chip_smoke.py --probe DIR

builds the kernels and runs, instead of the phases, the measurements
behind PERF.md's compositive and fine_window figures: the compositive
phase's drift ratio at 128^3 for spheres of 0.2, 0.1 and 0.05 m, with the
0.2 m sphere also under the exact composition (FUSED_PALLAS=0, the branch
the CPU tests hold to the JAX package) and over 12 frames; then a staged
frame (frame 4: each top-level stage timed on its own) and a profiled
frame (frame 5, torch.profiler) of the compositive and fine_window
scenes, and of the compositive scene under the exact composition with the
inverse warps on (warp_field3's exact form twice a frame: the composition
and the incremental inverse). Writes DIR/probe.json and each profiled
frame's key_averages table.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
DIM = 128
TAPS, LAMBDA = 7, 0.1
# the CLI gate's calibrated setting (tools/validate_cli_scene.py): 20 frames at 64^3
GATE_FRAMES, GATE_DIM = 20, 64
# the H100 SXM's published peaks at 700 W (NVIDIA's data sheet): HBM3 bytes
# per second and float32 operations per second outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float operations per voxel, counted from csrc/gd_step.cuh and sampling.cuh:
# axis_taps on three axes (window: two clamps, a subtraction, two clamps, a
# floor, an addition and two hat weights of four operations each; exact:
# two clamps, a floor, the fraction), a trilinear blend (7 of 3 operations)
TAPS_OPS = {"window": 45, "exact": 12}
TRILINEAR_OPS = 21
FLOOR_OPS = 21  # floor_coord on three axes


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


def tool(name: str):
    """tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_ms(fn, reps: int = 20, runs: int = 7, warmup: int = 3) -> float:
    """Milliseconds per call of fn(): one CUDA event pair around a run of
    reps calls, elapsed / reps, the median over runs. The calls of a run
    queue up behind one another, so the host's share of a call (allocations,
    checks, ctypes) hides behind the device work of the call before it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def device_ms(fn, reps: int = 20) -> float:
    """The profiler's device time per call of fn(): the self device time of
    every CUDA activity (kernels, memsets, copies) of reps calls under
    torch.profiler, over reps. Where a call is several kernels it is their
    sum; host gaps between them are left out. A run that records no device
    activity is repeated, twice at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device_us = tool("profile_torch_frame")._device_us
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no device activity: try again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(device_us(e) for e in prof.key_averages()
                    if "CUDA" in str(getattr(e, "device_type", "")))
        if total > 0:
            return total / reps * 1e-3
    raise RuntimeError("torch.profiler recorded no device time")


def gd_ops(n_taps: int, window: bool, momentum: bool, energy: bool) -> int:
    """Float operations of one A iteration per voxel: the potential (three
    central differences, tnp - tg, per channel three second differences,
    the negated Laplacian and dU: 52), the update (per channel three
    n_taps-tap convolutions, their sum, the step and psi - update; the
    squared norm), the momentum, the re-warp and the energy."""
    potential = 6 + 1 + 3 * (9 + 3 + 3)
    update = 3 * (6 * n_taps + 2 + 2) + 5 + (6 if momentum else 0)
    warp = TAPS_OPS["window" if window else "exact"] + TRILINEAR_OPS
    return potential + update + warp + (3 if energy else 0)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: int, ops: float):
    """(The least milliseconds the card could take: the bytes the function
    must move — each input read once, each output written once — at the
    memory rate, or its float operations at the FP32 rate, whichever is
    larger; which of the two it is)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn) -> dict:
    """A kernel call's two times: {"ms": cuda_ms, "device_ms": device_ms}."""
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}


def timed_chunks(kernels, name, psi, tnp, tg, live, taps, alpha, w_reg, momentum, K) -> dict:
    """Kernel A as the solve loops run it: chunks of GD_CHUNK iterations
    through kernels.GdLoop (one call and one host read a chunk, the stop test
    on the card, never met here), per iteration. Operands carry the scene
    axis."""
    loop = kernels.GdLoop(name, psi, tnp, tg, live, taps, alpha, w_reg, momentum, K, -1.0)
    on = np.ones(psi.shape[0], bool)
    n = kernels.GD_CHUNK
    return {"ms": cuda_ms(lambda: loop.run(n, on), reps=4) / n,
            "device_ms": device_ms(lambda: loop.run(n, on), reps=4) / n}


def plain_ms(fn) -> float:
    """A plain version's time (many small torch launches): short runs."""
    return cuda_ms(fn, reps=3, runs=3, warmup=1)


def row(err, times, plain, n_bytes, ops, library_ms=None) -> dict:
    """One kernel's entries of the report line; times is :func:`timed`'s."""
    bound_ms, bound_by = bound(n_bytes, ops)
    return {"max_abs_err": err, "ms": times["ms"], "device_ms": times["device_ms"],
            "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def max_abs(a, b) -> float:
    import torch

    if a is None and b is None:
        return 0.0
    return float(torch.max(torch.abs(a - b)))


def bitwise(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def smooth_displacement(dims, amp: float, seed: int, wavelength: float = 32.0) -> np.ndarray:
    """A smooth displacement f32[3, Z, Y, X] of amp voxels amplitude: each
    channel the mean of three sines of the wavelength (voxels) along z, y
    and x, with phases drawn from a numpy seed. Neighbouring voxels move
    together, as a solved field's do (unlike independent noise)."""
    rng = np.random.default_rng(seed)
    k = 2.0 * np.pi / wavelength
    axes = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in dims], indexing="ij")
    out = np.empty((3,) + tuple(dims), np.float32)
    for c in range(3):
        phases = rng.uniform(0.0, 2.0 * np.pi, 3)
        out[c] = amp * sum(np.sin(k * a + p) for a, p in zip(axes, phases)) / 3.0
    return out


def check_kernels(torch, kernels, fields, solver):
    """Phase 3: returns {name: report row} (:func:`row`)."""
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
    errs.append(check_gd_shapes(torch, kernels, solver))
    args = (psi_w, tnp, vel, tg, live, taps, alpha, w_reg, None, 2)
    times = timed_chunks(kernels, "gd_iteration", *(a[None] for a in args[:2]),
                         *(a[None] for a in args[3:5]), *args[5:])
    single = timed(lambda: kernels.gd_iteration(*args))
    log("kernels", f"gd_iteration as one call per iteration (fresh outputs each call): "
        f"{single['ms']:.4f} ms, {single['device_ms']:.4f} ms device")
    plain = plain_ms(lambda: kernels.gd_iteration_plain(*args))
    n = tg.numel()
    results["gd_iteration"] = row(max(errs), times, plain,
                                  nbytes(psi_w, tnp, tg, live, *kernels.gd_iteration(*args)[:2]),
                                  n * gd_ops(TAPS, True, False, False))
    check_gd_chunks(torch, kernels, fields, solver)

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
    vol2 = torch.stack([tg, wgc]).contiguous()
    also = {}
    for label, vol, floor, ops in (
        ("K=2, one channel", vol1, (False,), TAPS_OPS["window"] + TRILINEAR_OPS),
        # window_warp_pallas_mixed: the tails' warp, a trilinear and a floor channel
        ("K=2, mixed C=2", vol2, (False, True), TAPS_OPS["window"] + TRILINEAR_OPS + FLOOR_OPS),
    ):
        r = row(max(errs), timed(lambda: kernels.warp(vol, psi_w, 2, floor)),
                plain_ms(lambda: kernels.warp_plain(vol, psi_w, 2, floor)),
                nbytes(vol, psi_w, vol), n * ops)
        log("kernels", f"warp {label}: {r['ms']:.4f} ms kernel, {r['device_ms']:.4f} ms device, "
            f"{r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
        also[label] = r
    # the report's row: the exact warp, the function one library call computes;
    # B and the library call in turns (B, library, library, B) at psi_x and psi_w
    for label, psi in (("psi_w (+-1.8 voxels)", psi_w), ("psi_x (+-3.5 voxels)", psi_x)):
        lib, lib_err = library_warp(torch, vol1, psi, kernels.warp(vol1, psi, None, (False,)))
        check(lib_err <= 1e-4, "grid_sample does not compute B's exact warp")

        def b_call(psi=psi):
            return kernels.warp(vol1, psi, None, (False,))

        turns = [timed(b_call), timed(lib), timed(lib), timed(b_call)]
        log("kernels", f"warp exact at {label}, in turns B / grid_sample / grid_sample / B: ms "
            + " / ".join(f"{t['ms']:.4f}" for t in turns) + "; device ms "
            + " / ".join(f"{t['device_ms']:.4f}" for t in turns)
            + f" (the library yardstick, never called by the port; max|d| from B {lib_err:.3e})")
    b_times = {k: min(turns[0][k], turns[3][k]) for k in ("ms", "device_ms")}
    plain = plain_ms(lambda: kernels.warp_plain(vol1, psi_x, None, (False,)))
    results["warp"] = row(max(errs), b_times, plain, nbytes(vol1, psi_x, vol1),
                          n * (TAPS_OPS["exact"] + TRILINEAR_OPS),
                          min(turns[1]["ms"], turns[2]["ms"]))
    results["warp"]["library_device_ms"] = min(turns[1]["device_ms"], turns[2]["device_ms"])
    results["warp"]["also"] = also

    # C: inverse fixed point (warm 3 steps in the window, 48 exact from identity)
    results["inverse_fixed_point"] = check_inverse(torch, kernels, fields, t, rng)

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
    times = timed(lambda: kernels.warp_fuse(*args))
    plain = plain_ms(lambda: kernels.warp_fuse_plain(*args))
    # the floor sample, then the fuse's multiply-add, two additions, a division, a clamp
    results["warp_fuse"] = row(max(errs), times, plain, nbytes(tg, wgc, tnp_q, wnc, psi_w, tg, wgc),
                               n * (FLOOR_OPS + 6))
    # A's stall energy (the fine level's check iterations)
    args = (psi_w, tnp, vel, tg, live, taps, alpha, w_reg, 0.95, 2)
    e_got = kernels.gd_iteration(*args, with_energy=True)[4]
    e_ref = kernels.gd_iteration_plain(*args, with_energy=True)[4]
    e_rel = abs(float(e_got) - float(e_ref)) / abs(float(e_ref))
    same = bitwise(e_got, kernels.gd_iteration(*args, with_energy=True)[4])
    log("kernels", f"gd_iteration energy: rel d={e_rel:.3e} same bits on a rerun={same}")
    check(e_rel <= 1e-5 and same, "gd_iteration's energy disagrees with its plain version")
    t_e = timed(lambda: kernels.gd_iteration(*args, with_energy=True))
    log("kernels", f"gd_iteration with energy: {t_e['ms']:.4f} ms, {t_e['device_ms']:.4f} ms "
        "device (128^3, K=2, momentum 0.95)")

    results["gd_multi"] = check_gd_multi(torch, kernels, fields, solver)

    # F: compose_weight, bitwise (psi0 within 0.95 voxel, the increment
    # within Kf - 0.05: with Kf=2 psi_new leaves the Kw=2 window)
    errs = []
    psi0 = ident + t(rng.uniform(-0.95, 0.95, (3,) + dims))
    for Kf, Kw in ((1, 2), (2, 2)):
        g = ident + t(rng.uniform(-(Kf - 0.05), Kf - 0.05, (3,) + dims))
        got = kernels.compose_weight(psi0, g, wnc, Kf, Kw)
        ref = kernels.compose_weight_plain(psi0, g, wnc, Kf, Kw)
        bit = bitwise(got[0], ref[0]) and bitwise(got[1], ref[1])
        e = max(max_abs(got[0], ref[0]), max_abs(got[1], ref[1]))
        log("kernels", f"compose_weight Kf={Kf} Kw={Kw}: max|d|={e:.3e} bitwise={bit}")
        check(bit, "compose_weight is not bit-identical to its plain version")
        errs.append(e)
    g1 = ident + t(rng.uniform(-0.95, 0.95, (3,) + dims))
    times = timed(lambda: kernels.compose_weight(psi0, g1, wnc, 1, 2))
    plain = plain_ms(lambda: kernels.compose_weight_plain(psi0, g1, wnc, 1, 2))
    results["compose_weight"] = row(
        max(errs), times, plain, nbytes(psi0, g1, wnc, psi0, wnc),
        n * (TAPS_OPS["window"] + 3 * TRILINEAR_OPS + FLOOR_OPS))

    # B on three channels: warp_field3 bit for bit with its plain version and
    # with three one-channel B launches, inside and beyond the window, exact,
    # at the noise and at smooth fields
    errs = []
    field = ident + t(rng.uniform(-2.0, 2.0, (3,) + dims))
    smooth_x = ident + t(smooth_displacement(dims, 3.5, 1))   # the exact form's
    smooth_w = ident + t(smooth_displacement(dims, 1.95, 2))  # inside the K=2 window
    for K, psi, label in ((2, psi_w, "psi_w"), (2, psi_x, "psi_x"), (None, psi_x, "psi_x"),
                          (None, smooth_x, "smooth 3.5"), (2, smooth_w, "smooth 1.95"),
                          (1, psi_w, "psi_w"), (4, psi_x, "psi_x")):
        errs.append(check_field3(kernels, field, psi, K, f"K={K} at {label}"))
    # the report's row: the exact form at psi_x; under "also" the exact form at
    # the smooth field and K=2 at psi_w and at the smooth field. Each in turns
    # with grid_sample on the same operands (B, library, library, B); inside the
    # K=2 window grid_sample computes the same function
    rows = {}
    for label, K, psi in (("exact, psi_x (+-3.5 voxels)", None, psi_x),
                          ("exact, smooth 3.5", None, smooth_x),
                          ("K=2, psi_w (+-1.8 voxels)", 2, psi_w),
                          ("K=2, smooth 1.95", 2, smooth_w)):
        rows[label] = field3_row(torch, kernels, field, psi, K, label, ident, max(errs))
    main, *rest = rows
    results["warp_field3"] = rows[main]
    results["warp_field3"]["also"] = {k: rows[k] for k in rest}

    results["gd_iteration_scenes"] = check_gd_iteration_scenes(torch, kernels, fields, solver)

    where = {"gd_multi": "64^3, K=1, momentum 0.95, 16 iterations",
             "compose_weight": "128^3, Kf=1, Kw=2", "warp": "128^3, exact, one channel",
             "warp_field3": "128^3, exact, three channels",
             "gd_iteration_scenes": "4 scenes of 128^3, K=2, momentum 0.95"}
    for name, r in results.items():
        log("kernels", f"{name}: {r['ms']:.4f} ms kernel (a run of 20 calls between one event "
            f"pair, median of 7), {r['device_ms']:.4f} ms device (profiler), {r['plain_ms']:.4f} "
            f"ms plain, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({where.get(name, '128^3, K=2')})")
    return results


def check_inverse(torch, kernels, fields, t, rng):
    """Kernel C at its three paths' shapes: the slice's warm window inverse
    (128^3, K=2, 3 steps from a warm start), the pyramid's multigrid coarse
    inverse (64^3, K=1, 3 warm steps) and the shipped ini's exact one (128^3,
    48 steps from the identity), and 3 steps at 128^3, K=2 from the
    identity (checked, not timed). Each within 1e-5 of its plain version,
    and whether bit for bit. Returns the
    report row (the slice's shape) with the other two shapes under "also"."""
    dev = torch.device(DEVICE)

    def case(n, K, iters, warm):
        dims = (n, n, n)
        psi = fields.identity_field(dims, device=dev) + t(rng.uniform(-0.9, 0.9, (3,) + dims))
        init = kernels.inverse_fixed_point_plain(psi, 2, K) if warm else None
        return psi, iters, K, init

    rows, errs = {}, []
    for label, (n, K, iters, warm) in (
        ("128^3, K=2, 3 warm steps", (DIM, 2, 3, True)),
        ("64^3, K=1, 3 warm steps", (DIM // 2, 1, 3, True)),
        ("128^3, exact, 48 steps from the identity", (DIM, None, 48, False)),
        ("128^3, K=2, 3 steps from the identity", (DIM, 2, 3, False)),
    ):
        args = case(n, K, iters, warm)
        got = kernels.inverse_fixed_point(*args)
        ref = kernels.inverse_fixed_point_plain(*args)
        e = max_abs(got, ref)
        log("kernels", f"inverse_fixed_point {label}: max|d|={e:.3e} bitwise={bitwise(got, ref)}")
        check(e <= 1e-5, "inverse_fixed_point disagrees with its plain version")
        errs.append(e)
        if "identity" in label and K is not None:
            continue
        psi, _, _, init = args
        # the displacement once, then per step the taps and, per channel, a
        # trilinear blend and the identity minus it
        taps = TAPS_OPS["exact" if K is None else "window"]
        rows[label] = row(e, timed(lambda: kernels.inverse_fixed_point(*args)),
                          plain_ms(lambda: kernels.inverse_fixed_point_plain(*args)),
                          nbytes(psi, init, psi),
                          psi[0].numel() * (3 + iters * (taps + 3 * (TRILINEAR_OPS + 1))))
        r = rows[label]
        log("kernels", f"inverse_fixed_point {label}: {r['ms']:.4f} ms kernel, "
            f"{r['device_ms']:.4f} ms device, {r['plain_ms']:.4f} ms plain, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
    main, *also = rows
    out = dict(rows[main], max_abs_err=max(errs))
    out["also"] = {k: rows[k] for k in also}
    return out


def gd_inputs(torch, dims, seed, amp, scenes=None):
    """Random operands of kernel A on the card: psi within amp voxels of the
    identity, standard-normal volumes scaled 0.3, velocities scaled 0.1;
    with scenes = S a leading scene axis."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    lead = () if scenes is None else (scenes,)
    ident = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")[::-1])
    arrays = dict(
        psi=ident + rng.uniform(-amp, amp, lead + (3,) + dims),
        tnp=rng.standard_normal(lead + dims) * 0.3,
        vel=rng.standard_normal(lead + (3,) + dims) * 0.1,
        tg=rng.standard_normal(lead + dims) * 0.3,
        live=rng.standard_normal(lead + dims) * 0.3,
    )
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32), device=dev)
            for k, v in arrays.items()}


def check_gd_shapes(torch, kernels, solver) -> float:
    """Kernel A against its plain version on the other grids the port runs
    — the parity grid (12, 16, 20), the goldens' 16^3 and the coarse
    level's 64^3 — with every tap count its template takes, windowed and
    exact, with and without momentum (atol 1e-5 on the state, rtol 1e-5 on
    the norm and the energy). Returns the largest state difference."""
    worst = 0.0
    for dims, s, K, mu in (((12, 16, 20), 7, 2, 0.9), ((12, 16, 20), 3, None, None),
                           ((12, 16, 20), 11, 1, 0.95), ((12, 16, 20), 5, 2, None),
                           ((12, 16, 20), 9, None, 0.9), ((16, 16, 16), 7, 2, None),
                           ((16, 16, 16), 7, None, 0.95), ((64, 64, 64), 7, 1, 0.95)):
        d = gd_inputs(torch, dims, 11, 1.5)
        taps = torch.as_tensor(solver.sobolev_filter_1d(s, LAMBDA), device=d["psi"].device)
        args = (d["psi"], d["tnp"], d["vel"], d["tg"], d["live"], taps, 0.05, 0.2, mu, K)
        got = kernels.gd_iteration(*args, with_energy=True)
        ref = kernels.gd_iteration_plain(*args, with_energy=True)
        e = max(max_abs(g, r) for g, r in zip(got[:3], ref[:3]))
        rel = max(abs(float(g) - float(r)) / max(abs(float(r)), 1e-30)
                  for g, r in zip(got[3:], ref[3:]))
        plan = kernels.gd_tile_plan(dims, s, torch.cuda.get_device_properties(0)
                                    .multi_processor_count)
        log("kernels", f"gd_iteration {'x'.join(map(str, dims))} taps={s} K={K} momentum={mu}: "
            f"max|d|={e:.3e} rel d(max_sq, energy)={rel:.3e}; {plan['blocks']} blocks of "
            f"{plan['TY']}x32 x {plan['LZ']} planes, {plan['shared_bytes']} B shared")
        check(e <= 1e-5 and rel <= 1e-5, "gd_iteration disagrees with its plain version")
        worst = max(worst, e)
    return worst


def check_gd_chunks(torch, kernels, fields, solver, dims=(64, 64, 64)):
    """The chunked entry point (kernels.GdLoop, n iterations per call with
    the stop test on the card) against n one-iteration launches with the
    stop test on the host, bit for bit: state, norm rows, the iterations
    each scene ran, the energy. At 64^3, 7 taps, K=2: one scene whose norm
    stop falls inside a chunk of 16; three scenes with momentum 0.5, one
    frozen from the start, one stopping inside the chunk, with the energy
    of the last iteration; then a second chunk from the state the first
    left (the buffers' parity differs between scenes)."""
    n = 16
    dev = torch.device(DEVICE)
    taps = torch.as_tensor(solver.sobolev_filter_1d(TAPS, LAMBDA), device=dev)

    def reference(b, mu, thresh, active, n, with_energy):
        """n gd_iteration_scenes launches, the host deciding who runs."""
        psi, tnp, vel = b["psi"], b["tnp"], b["vel"] if mu is not None else None
        S = psi.shape[0]
        on = np.asarray(active, bool).copy()
        done, rows, e = np.zeros(S, np.int32), np.zeros((n, S), np.float32), None
        for k in range(n):
            if k:
                on &= np.sqrt(rows[k - 1]) > np.float32(thresh)
            if not on.any():
                break
            last = with_energy and k == n - 1
            out = kernels.gd_iteration_scenes(psi, tnp, vel, b["tg"], b["live"], taps, 0.05, 0.2,
                                              mu, 2, torch.as_tensor(on, device=dev), last)
            psi, tnp, vel = out[:3]
            rows[k] = out[3].cpu().numpy()
            done += on
            if last:
                e = out[4].cpu().numpy()
        return dict(b, psi=psi, tnp=tnp, vel=vel), done, rows, e

    def compare(label, b, mu, thresh, active, with_energy, chunks=1):
        loop = kernels.GdLoop("gd_iteration_scenes", b["psi"], b["tnp"], b["tg"], b["live"],
                              taps, 0.05, 0.2, mu, 2, thresh, energy=with_energy)
        ref = b
        for chunk in range(chunks):
            got = loop.run(n, active, with_energy)
            ref, *want = reference(ref, mu, thresh, active, n, with_energy)
            psi, tnp, vel = loop.state()
            same = (bitwise(psi, ref["psi"]) and bitwise(tnp, ref["tnp"])
                    and (mu is None or bitwise(vel, ref["vel"]))
                    and all(np.array_equal(g, w) for g, w in zip(got, want) if w is not None))
            log("kernels", f"gd chunk {label}, chunk {chunk}: iterations run {got[0].tolist()} "
                f"of {n}, bit for bit with {n} single launches {same}")
            check(same, f"the chunked gd loop differs from single launches ({label})")
            active = active & (got[0] == n)
        return got

    def stop_at(norms):
        """The last of the first 13 iterations whose norm is under every
        earlier one: a threshold of that norm stops the scene just there."""
        return max(k for k in range(13) if k == 0 or norms[k] < norms[:k].min())

    # one scene, no momentum
    b = gd_inputs(torch, dims, 21, 1.5, scenes=1)
    _, _, rows, _ = reference(b, None, -1.0, np.ones(1, bool), n, False)
    norms = np.sqrt(rows[:, 0])
    j = stop_at(norms)
    kernels.reset_launch_counts()
    done = compare(f"one scene, norm stop after iteration {j + 1}", b, None, float(norms[j]),
                   np.ones(1, bool), False)[0]
    check(int(done[0]) == j + 1, "the chunk did not stop where the norm fell under the threshold")
    check(kernels.launch_counts["gd_iteration_scenes"] == 2 * (j + 1)
          and kernels.empty_launches["gd_iteration_scenes"] == n - j - 1
          and kernels.host_reads["gd_iteration_scenes"] == 1,
          "the chunk's iteration, empty-launch and host-read counts")
    # three scenes, momentum: scene 1 frozen from the start, scene 2 stops early
    b = gd_inputs(torch, dims, 22, 1.5, scenes=3)
    b["vel"].zero_()  # a solve starts from rest
    ident = fields.identity_field(dims, device=dev)
    b["psi"][2] = ident + 0.3 * (b["psi"][2] - ident)  # smaller updates than scene 0's
    active = np.array([True, False, True])
    _, _, rows, _ = reference(b, 0.5, -1.0, active, n, False)
    norms = np.sqrt(rows[:, 2])
    log("kernels", "gd chunk norms of scenes 0 and 2 over 16 iterations: "
        + ", ".join(f"{a:.4f}/{c:.4f}" for a, c in zip(np.sqrt(rows[:, 0]), norms)))
    compare(f"three scenes, momentum 0.5, scene 1 frozen, scene 2 stopping after iteration "
            f"{stop_at(norms) + 1}", b, 0.5, float(norms[stop_at(norms)]), active, True,
            chunks=2)
    kernels.reset_launch_counts()


def library_warp(torch, vol, psi, want):
    """B's exact warp of the C channels of vol f32[C,Z,Y,X] as one library
    call, timed beside B as library_ms and called nowhere in the port:
    torch.nn.functional.grid_sample on a 5-D input of C channels, trilinear
    ("bilinear" on 5-D), "border" padding (the clamp to [0, n - 1]),
    align_corners (voxel 0 at -1 and voxel n - 1 at 1); the grid is built
    from psi outside the timed call. Returns (the call, its max |difference|
    from B's output ``want``)."""
    import torch.nn.functional as F

    _, Z, Y, X = vol.shape
    ext = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32, device=vol.device)
    grid = (psi.permute(1, 2, 3, 0) / ext * 2.0 - 1.0)[None].contiguous()
    inp = vol[None].contiguous()

    def call():
        return F.grid_sample(inp, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    return call, max_abs(call()[0], want)


def field3_by_channel(kernels, field, pos, K):
    """warp_field3's function as three one-channel B launches (kernels.warp)."""
    import torch

    return torch.cat([kernels.warp(field[c:c + 1], pos, K, (False,)) for c in range(3)])


def check_field3(kernels, field, pos, K, label) -> float:
    """warp_field3 bit for bit with its plain version and with three
    one-channel B launches on the same operands; returns its max |difference|
    from the plain version."""
    got = kernels.warp_field3(field, pos, K)
    ref = kernels.warp_field3_plain(field, pos, K)
    plain = bitwise(got, ref)
    by_channel = bitwise(got, field3_by_channel(kernels, field, pos, K))
    log("kernels", f"warp_field3 {label}: bitwise with its plain version {plain}, with three "
        f"one-channel B launches {by_channel}")
    check(plain and by_channel, f"warp_field3 {label} is not bit for bit with its plain "
          "version and three one-channel B launches")
    return max_abs(got, ref)


def field3_row(torch, kernels, field, pos, K, label, ident, err):
    """warp_field3 at (field, pos, K) in turns with grid_sample (B, library,
    library, B): its report row (max_abs_err err; the faster of B's two
    turns), grid_sample's time as library_ms and library_device_ms. The exact
    form, and the K form where every displacement from ident is under K, is
    grid_sample's function (held to 1e-4)."""
    want = kernels.warp_field3(field, pos, K)
    lib, lib_err = library_warp(torch, field, pos, want)
    if K is None or float((pos - ident).abs().max()) < K:
        check(lib_err <= 1e-4, f"grid_sample does not compute warp_field3 {label}")

    def call():
        return kernels.warp_field3(field, pos, K)

    turns = [timed(call), timed(lib), timed(lib), timed(call)]
    log("kernels", f"warp_field3 {label}, in turns B / grid_sample / grid_sample / B: ms "
        + " / ".join(f"{t['ms']:.4f}" for t in turns) + "; device ms "
        + " / ".join(f"{t['device_ms']:.4f}" for t in turns)
        + f" (max|d| from B {lib_err:.3e})")
    taps = TAPS_OPS["exact" if K is None else "window"]
    r = row(err, {k: min(turns[0][k], turns[3][k]) for k in ("ms", "device_ms")},
            plain_ms(lambda: kernels.warp_field3_plain(field, pos, K)),
            nbytes(field, pos, want), field[0].numel() * (taps + 3 * TRILINEAR_OPS),
            min(turns[1]["ms"], turns[2]["ms"]))
    r["library_device_ms"] = min(turns[1]["device_ms"], turns[2]["device_ms"])
    return r


def field3_real_rows(torch, kernels, fields, ops):
    """warp_field3 on the operands of a real composition (the compositive
    phase's last, psi0 o g at 128^3), exact and K=2: bit for bit with its
    plain version and three one-channel B launches, then each in turns with
    grid_sample (:func:`field3_row`). Returns the rows by label."""
    field, pos = ops["field"], ops["pos"]
    ident = fields.identity_field(tuple(field.shape[1:]), device=field.device)
    log("kernels", f"warp_field3 on the compositive phase's last composition (K={ops['K']}): "
        f"max |g - id| {float((pos - ident).abs().max()):.4f} voxels, max |psi0 - id| "
        f"{float((field - ident).abs().max()):.4f}")
    rows = {}
    for K in (None, 2):
        label = f"{'exact' if K is None else f'K={K}'}, a real composition"
        err = check_field3(kernels, field, pos, K, label)
        rows[label] = field3_row(torch, kernels, field, pos, K, label, ident, err)
    return rows


def check_gd_iteration_scenes(torch, kernels, fields, solver):
    """A over S = 4 scenes at 128^3, K=2, momentum 0.95 (the multiscene
    phase's fine level). With scene 2 inactive: against its plain version
    (atol 1e-5 on the state, rtol 1e-5 on the norms and energies), each
    active scene bit for bit against an unbatched A launch, the inactive
    scene passed through with norm and energy 0. Then all four active,
    timed against one unbatched A launch (the same options). Returns its
    report row."""
    from sobfu_tpu_torch.tsdf import init_sphere

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(3)
    dims, vs, S = (DIM,) * 3, 1.0 / DIM, 4

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    ident = fields.identity_field(dims, device=dev)
    spheres = [init_sphere(dims, (vs,) * 3, (0.5 + 0.01 * d, 0.5, 0.5), 0.2, 8 * vs, 3 * vs,
                           device=dev)[0] for d in range(-S, S + 1)]
    b = {
        "psi": torch.stack([ident + t(rng.uniform(-1.8, 1.8, (3,) + dims)) for _ in range(S)]),
        "tnp": torch.stack([spheres[s] + t(rng.normal(0.0, 0.05, dims)) for s in range(S)]),
        "vel": t(rng.normal(0.0, 0.1, (S, 3) + dims)),
        "tg": torch.stack(spheres[S:2 * S]),
        "live": torch.stack(spheres[1:S + 1]),
    }
    taps = torch.as_tensor(solver.sobolev_filter_1d(TAPS, LAMBDA), device=dev)
    args = (b["psi"], b["tnp"], b["vel"], b["tg"], b["live"], taps, 0.05, 0.2, 0.95, 2)
    active = torch.tensor([True, True, False, True], device=dev)
    got = kernels.gd_iteration_scenes(*args, active, with_energy=True)
    ref = kernels.gd_iteration_scenes_plain(*args, active, with_energy=True)
    err = max(max_abs(g, r) for g, r in zip(got[:3], ref[:3]))
    rel = max(float(torch.max(torch.abs(g - r) / torch.abs(r).clamp_min(1e-30)))
              for g, r in zip(got[3:], ref[3:]))
    bit = all(
        all(bitwise(g[s], w) for g, w in zip(got, kernels.gd_iteration(
            *(b[k][s] for k in ("psi", "tnp", "vel", "tg", "live")), taps, 0.05, 0.2, 0.95, 2,
            with_energy=True)))
        for s in (0, 1, 3)
    )
    kept = (bitwise(got[0][2], b["psi"][2]) and bitwise(got[1][2], b["tnp"][2])
            and bitwise(got[2][2], b["vel"][2]) and float(got[3][2]) == float(got[4][2]) == 0.0)
    log("kernels", f"gd_iteration_scenes S={S}, scene 2 inactive: max|d| {err:.3e}, max rel d "
        f"norms and energies {rel:.3e}; active scenes bitwise with unbatched A {bit}; the "
        f"inactive scene kept {kept}")
    check(err <= 1e-5 and rel <= 1e-5, "gd_iteration_scenes disagrees with its plain version")
    check(bit, "gd_iteration_scenes is not bit-identical to unbatched gd_iteration per scene")
    check(kept, "gd_iteration_scenes changed an inactive scene")
    on = torch.ones(S, dtype=torch.bool, device=dev)
    times = timed_chunks(kernels, "gd_iteration_scenes", b["psi"], b["tnp"], b["tg"], b["live"],
                         taps, 0.05, 0.2, 0.95, 2)
    one = timed_chunks(kernels, "gd_iteration", *(b[k][:1] for k in ("psi", "tnp", "tg", "live")),
                       taps, 0.05, 0.2, 0.95, 2)
    single = timed(lambda: kernels.gd_iteration_scenes(*args, on))
    log("kernels", f"gd_iteration_scenes as one call per iteration: {single['ms']:.4f} ms, "
        f"{single['device_ms']:.4f} ms device")
    plain = plain_ms(lambda: kernels.gd_iteration_scenes_plain(*args, on))
    for k in ("ms", "device_ms"):
        log("kernels", f"gd_iteration_scenes {k}: {times[k]:.4f} per batched iteration of {S} "
            f"scenes, unbatched A {one[k]:.4f} x {S} = {S * one[k]:.4f} (ratio "
            f"{times[k] / (S * one[k]):.4f})")
    out = kernels.gd_iteration_scenes(*args, on)
    return row(err, times, plain, nbytes(*b.values(), *out[:3]),
               S * ident[0].numel() * gd_ops(TAPS, True, True, False))


def check_gd_multi(torch, kernels, fields, solver):
    """Kernel E at the coarse level's shapes: 64^3, K=1, momentum 0.95,
    n_inner=16. Against its plain version (atol 1e-5 on the state, rtol 1e-5
    on the rows) and bit for bit against 16 chained A launches. Returns its
    report row; logs 16 chained A launches' time too."""
    from sobfu_tpu_torch.tsdf import init_sphere

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)
    n = 64
    dims, vs = (n, n, n), 1.0 / n

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    tg, _ = init_sphere(dims, (vs,) * 3, (0.5, 0.5, 0.5), 0.2, 8 * vs, 3 * vs, device=dev)
    live, _ = init_sphere(dims, (vs,) * 3, (0.49, 0.5, 0.5), 0.2, 8 * vs, 3 * vs, device=dev)
    psi = fields.identity_field(dims, device=dev) + t(rng.uniform(-0.9, 0.9, (3,) + dims))
    tnp = live + t(rng.normal(0.0, 0.05, dims))
    vel = t(rng.normal(0.0, 0.1, (3,) + dims))
    taps = torch.as_tensor(solver.sobolev_filter_1d(TAPS, LAMBDA), device=dev)
    args = (psi, tnp, vel, tg, live, taps, 0.05, 0.2, 0.95, 1, 16)
    errs = []
    for verbose in (False, True):
        got = kernels.gd_multi(*args, with_energy=True, with_verbose=verbose)
        ref = kernels.gd_multi_plain(*args, with_energy=True, with_verbose=verbose)
        e = max(max_abs(g, r) for g, r in zip(got[:3], ref[:3]))
        rel = max(
            float(torch.max(torch.abs(g - r) / torch.abs(r).clamp_min(1e-30)))
            for g, r in zip(got[3:], ref[3:]) if r is not None
        )
        log("kernels", f"gd_multi verbose={verbose}: max|d| state={e:.3e} "
            f"max rel d rows={rel:.3e}")
        check(e <= 1e-5 and rel <= 1e-5, "gd_multi disagrees with its plain version")
        errs.append(e)

    def chained():
        p, q, v = psi, tnp, vel
        rows = []
        for _ in range(16):
            p, q, v, mx, en = kernels.gd_iteration(p, q, v, tg, live, taps, 0.05, 0.2, 0.95, 1,
                                                   with_energy=True)
            rows.append((mx, en))
        return p, q, v, rows

    got = kernels.gd_multi(*args, with_energy=True)
    p, q, v, rows = chained()
    bit = bitwise(got.psi, p) and bitwise(got.tnp, q) and bitwise(got.vel, v) and all(
        bitwise(got.mx_sq[i], mx) and bitwise(got.e_data[i], en)
        for i, (mx, en) in enumerate(rows)
    )
    log("kernels", f"gd_multi vs 16 chained gd_iteration: bitwise={bit}")
    check(bit, "gd_multi is not bit-identical to 16 chained gd_iteration launches")
    check_gd_multi_loop(torch, kernels, solver, psi, tnp, tg, live, taps)
    times = timed(lambda: kernels.gd_multi(*args))
    t_a = {"ms": cuda_ms(chained, reps=5), "device_ms": device_ms(chained, reps=5)}
    plain = plain_ms(lambda: kernels.gd_multi_plain(*args))
    loop = kernels.GdMultiLoop(psi, tnp, tg, live, taps, 0.05, 0.2, 0.95, 1, -1.0, 1 << 30, 16)
    m = kernels.GD_MULTI_LAUNCHES
    t_loop = {"ms": cuda_ms(lambda: loop.run(m), reps=4) / m,
              "device_ms": device_ms(lambda: loop.run(m), reps=4) / m}
    log("kernels", f"gd_multi 16 iterations at 64^3: {times['ms']:.4f} ms one launch "
        f"({times['device_ms']:.4f} ms device), through GdMultiLoop ({m} launches a call) "
        f"{t_loop['ms']:.4f} ms a launch ({t_loop['device_ms']:.4f} ms device), 16 chained "
        f"gd_iteration (with energy) {t_a['ms']:.4f} ms ({t_a['device_ms']:.4f} ms device), "
        f"{plain:.4f} ms plain")
    out = kernels.gd_multi(*args)
    return row(max(errs), times, plain,
               nbytes(psi, tnp, vel, tg, live, out.psi, out.tnp, out.vel, out.mx_sq),
               16 * tg.numel() * gd_ops(TAPS, True, True, False))


def check_gd_multi_loop(torch, kernels, solver, psi, tnp, tg, live, taps):
    """Kernel E's loop (kernels.GdMultiLoop: up to GD_MULTI_LAUNCHES launches
    a host read, the stop test on the card) against one launch a chunk with
    the test on the host, bit for bit (state, velocity, iterations, last
    norm, the stall) at the coarse level's shapes (64^3, K=1, momentum
    0.95): a norm stop inside a chunk, a cap of 40 (overshot to 48) and a
    stall stop; and the launch, empty-launch and host-read counts."""
    def per_chunk(max_iter, thresh, stall_window, stall_rel):
        p, q, v = psi, tnp, torch.zeros_like(psi)
        it, mnorm, e_ref, stalled, rows = 0, float("inf"), float("inf"), False, []
        while it < max_iter and mnorm > thresh and not stalled:
            it += 16
            at_check = bool(stall_window) and it % stall_window == 0
            o = kernels.gd_multi(p, q, v, tg, live, taps, 0.05, 0.2, 0.95, 1, 16,
                                 with_energy=at_check)
            p, q, v = o.psi, o.tnp, o.vel
            rows.append(o.mx_sq.cpu().numpy())
            mnorm = float(np.sqrt(rows[-1][-1]))
            if at_check:
                stalled, e_ref = solver.stall_check(float(o.e_data[-1]), e_ref, it,
                                                    stall_window, stall_rel)
        return (p, q, v), (it, mnorm, stalled), np.concatenate(rows)

    _, _, rows = per_chunk(48, -1.0, 0, 0.0)
    thresh = float(np.float32(np.sqrt(rows[47])))  # stops by the third chunk's end
    for label, (max_iter, th, sw, rel) in (("norm stop", (1024, thresh, 0, 0.0)),
                                            ("cap 40", (40, -1.0, 0, 0.0)),
                                            ("stall", (1024, -1.0, 16, 1.0))):
        want_state, want, _ = per_chunk(max_iter, th, sw, rel)
        kernels.reset_launch_counts()
        loop = kernels.GdMultiLoop(psi, tnp, tg, live, taps, 0.05, 0.2, 0.95, 1, th, max_iter,
                                   16, sw, rel)
        while loop.running:
            loop.run(min(kernels.GD_MULTI_LAUNCHES, -(-(max_iter - loop.count) // 16)))
        got = (loop.count, loop.mnorm, loop.stalled)
        same = got == want and all(bitwise(a, b) for a, b in zip(loop.state(), want_state))
        counts = (kernels.launch_counts["gd_multi"], kernels.empty_launches["gd_multi"],
                  kernels.host_reads["gd_multi"])
        log("kernels", f"gd_multi loop, {label}: iterations {got[0]}, last norm {got[1]:.6e}, "
            f"stalled {got[2]}; launches that ran / empty / host reads {counts}; bit for bit "
            f"with one launch a chunk {same}")
        check(same, f"GdMultiLoop differs from one launch a chunk ({label})")
        check(counts[0] == got[0] // 16 and counts[2] == -(-counts[0] // kernels.GD_MULTI_LAUNCHES),
              f"GdMultiLoop's launch and host-read counts ({label})")
        if label == "cap 40":
            check(got[0] == 48, "GdMultiLoop: a cap of 40 runs 48 iterations")
        if label == "stall":
            check(got[2], "GdMultiLoop: the stall did not stop the loop")
    kernels.reset_launch_counts()


# ---------------------------------------------------------------------------
# phase 3b: the front end, kernels P and I (sobfu_tpu_torch/ops/frontend.py)
# ---------------------------------------------------------------------------

# float operations of kernel P: a valid tap (the difference, its square, the
# colour and spatial terms, the negation, exp, nb * w and the two sums); a
# pixel's tail (the mean, its rounding, the truncation test, xl and yl, lam
# and the dists); kernel I a voxel (the centre's three coordinates, 1 / z,
# u and v, the image test and floors, psdf, the weight test, the scaled clamp)
PRE_TAP_OPS, PRE_PIXEL_OPS, INTEGRATE_OPS = 9, 14, 24


def frontend_depth(params, seed):
    """int32 mm at the ini's 640x480: the main path's sphere (0.2 m, 0.8 m
    away) before a wall at 1.6 m (past TRUNC_DEPTH), 1.5 mm of noise and 3%
    holes."""
    d = render_frames(params, 1, 0.0, 0.2)[0].astype(np.float64)
    d = np.where(d > 0, d, 1600.0)
    rng = np.random.default_rng(seed)
    d += rng.normal(0.0, 1.5, d.shape)
    d[rng.random(d.shape) < 0.03] = 0.0
    return np.clip(np.round(d), 0, 65535).astype(np.int32)


def valid_taps(H, W, k) -> int:
    """Kernel P's valid taps over an H x W map (rows in [0, H - 2], columns
    in [0, W - 2]): the work its window does, whatever the depths."""
    r = k // 2
    def per(n):
        return sum(0 <= i + o <= n - 2 for i in range(n) for o in range(-r, k - r))

    return per(H) * per(W)


def torch_roundings(torch):
    """How torch rounds, on the card, the two operations kernel I copies:
    torch.addcmul (its product rounded, then the sum, or one fused
    rounding) and a [3, 3] x [3, N] einsum (an FMA chain over j = 0, 1, 2
    or 2, 1, 0, or separate products and sums). Fractions of 2^20 random
    operands each form reproduces exactly, from float64 emulations."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(11)
    n = 1 << 20
    a, b, c = (rng.uniform(-2.0, 2.0, n).astype(np.float32) for _ in range(3))
    f64 = lambda v: v.astype(np.float64)  # noqa: E731
    r32 = lambda v: np.asarray(v, np.float64).astype(np.float32)  # noqa: E731
    got = torch.addcmul(*(torch.as_tensor(v, device=dev) for v in (a, b, c))).cpu().numpy()
    out = {"addcmul_fused": float(np.mean(got == r32(f64(a) + f64(b) * f64(c)))),
           "addcmul_two_roundings": float(np.mean(got == r32(f64(a) + f64(r32(f64(b) * c)))))}
    m = rng.uniform(-1.0, 1.0, (3, 3)).astype(np.float32)
    v = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    got = torch.einsum("ij,jn->in", torch.as_tensor(m, device=dev),
                       torch.as_tensor(v, device=dev)).cpu().numpy()
    prod = [f64(m[:, j:j + 1]) * f64(v[j:j + 1]) for j in range(3)]  # exact in float64
    for label, order in (("einsum_fma_chain", (0, 1, 2)), ("einsum_fma_reversed", (2, 1, 0))):
        acc = r32(prod[order[0]])
        for j in order[1:]:
            acc = r32(prod[j] + f64(acc))
        out[label] = float(np.mean(got == acc))
    sep = r32(f64(r32(prod[0])) + f64(r32(prod[1])))
    out["einsum_separate"] = float(np.mean(got == r32(f64(sep) + f64(r32(prod[2])))))
    return out


def check_frontend(torch, params):
    """Phase 3b: kernel P at the ini's 640x480 (k = 7, 5, 3, truncation on
    and off, and 479 x 637) and kernel I at 128^3 (the cell's axis-aligned
    pose, a z-slab at z_offset 64, 1.2 m of volume, and a pose turned 4
    degrees about y and 2 about x) against their plain versions on the card; P and the axis-aligned
    I bit for bit, the turned pose's voxels that read another pixel (over
    1e-4 apart) counted and the rest within 1e-6. Returns {name: report row}
    at the main path's shapes (k = 7 with the truncation; the axis-aligned
    128^3 volume)."""
    from sobfu_tpu_torch.ops import frontend, imgproc

    dev = torch.device(DEVICE)
    log("frontend", "torch on the card: " + json.dumps(torch_roundings(torch)))
    sig = (params.bilateral_sigma_spatial, params.bilateral_sigma_depth)
    intr, trunc = params.intr, params.icp_truncate_depth_dist
    rows = {}
    for H, W, k, cut in ((480, 640, 7, trunc), (480, 640, 7, 0.0), (480, 640, 5, trunc),
                         (480, 640, 3, 0.0), (479, 637, 7, trunc)):
        depth = torch.as_tensor(frontend_depth(params, k)[:H, :W].copy(), device=dev)
        args = (depth, k, *sig, cut, intr)
        got, ref = frontend.preprocess_depth(*args), frontend.preprocess_depth_plain(*args)
        bad = int((got != ref).sum())
        # the filtered mm behind each dists value: dists / (1 mm's dists), rounded
        per_mm = imgproc.compute_dists(torch.ones_like(depth), intr).double()
        mm = lambda d: torch.round(d.double() / per_mm)  # noqa: E731
        log("frontend", f"preprocess_depth {H}x{W} k={k} truncate={cut}: {bad} pixels differ, "
            f"max|d| {max_abs(got, ref):.3e} m, {float((mm(got) - mm(ref)).abs().max()):.0f} "
            f"mm at most")
        check(bad == 0, f"preprocess_depth {H}x{W} k={k} disagrees with its plain version")
        if (H, W, k, cut) == (480, 640, 7, trunc):
            n_ops = valid_taps(H, W, k) * PRE_TAP_OPS + H * W * PRE_PIXEL_OPS
            rows["preprocess_depth"] = row(
                max_abs(got, ref), timed(lambda: frontend.preprocess_depth(*args)),
                plain_ms(lambda: frontend.preprocess_depth_plain(*args)),
                nbytes(depth, got), n_ops)
    dists = frontend.preprocess_depth(torch.as_tensor(frontend_depth(params, 3), device=dev), 7,
                                      *sig, trunc, intr)
    dims = (DIM, DIM, DIM)
    rng = np.random.default_rng(7)
    for label, rot, z_offset, nz, size in (
            ("axis-aligned", 0.0, 0, DIM, 1.0), ("z-slab", 0.0, 64, 32, 1.0),
            ("axis-aligned 1.2 m", 0.0, 0, DIM, 1.2), ("turned", 4.0, 0, DIM, 1.0),
            ("turned z-slab", 4.0, 64, 32, 1.0)):
        vs = size / DIM  # 1.2 m: no power of two, so addcmul's single rounding shows
        tsdf = torch.as_tensor(rng.uniform(-1, 1, (nz,) + dims[1:]), dtype=torch.float32,
                               device=dev)
        weight = torch.as_tensor(rng.integers(0, 4, (nz,) + dims[1:]), dtype=torch.float32,
                                 device=dev)
        vol2cam = np.linalg.inv(np.eye(4, dtype=np.float32)) @ params.volume_pose
        vol2cam = np.asarray(vol2cam, np.float32)
        vol2cam[:2, 3] *= size
        if rot:
            a, b = np.deg2rad(rot), np.deg2rad(0.5 * rot)
            ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
            rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
            vol2cam[:3, :3] = (ry @ rx).astype(np.float32)
        args = (tsdf, weight, dists, vol2cam, intr, (vs,) * 3, params.tsdf_trunc_dist * size,
                params.eta * size, not rot, z_offset)
        (t, w), (pt, pw) = frontend.integrate_dists(*args), frontend.integrate_dists_plain(*args)
        err = (t - pt).abs()
        moved = (err > 1e-4) | (w != pw)
        rest = float(err[~moved].max()) if bool((~moved).any()) else 0.0
        seen = int((w != weight).sum())
        log("frontend", f"integrate_dists {label} {nz}x{DIM}x{DIM} z_offset={z_offset}: "
            f"{int(moved.sum())} voxels read another pixel, max|d| {rest:.3e} on the rest, "
            f"bitwise {bitwise(t, pt) and bitwise(w, pw)}; {seen} voxels integrated")
        check(seen > 1000, f"integrate_dists {label}: the frame integrated nothing")
        if rot:
            check(int(moved.sum()) <= 64 and rest <= 1e-6,
                  f"integrate_dists {label} disagrees with its plain version")
        else:
            check(bitwise(t, pt) and bitwise(w, pw),
                  f"integrate_dists {label} disagrees with its plain version")
        if label == "axis-aligned":
            n_bytes = nbytes(tsdf, weight, dists, t, w)
            rows["integrate_dists"] = row(
                max(max_abs(t, pt), max_abs(w, pw)),
                timed(lambda: frontend.integrate_dists(*args)),
                plain_ms(lambda: frontend.integrate_dists_plain(*args)),
                n_bytes, tsdf.numel() * INTEGRATE_OPS)
    for name, r in rows.items():
        log("frontend", f"{name}: {r['ms']:.4f} ms, {r['device_ms']:.4f} ms device, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms")
    return rows


def frontend_report(frontend, rows, launches) -> str:
    """The front end's line: kernels P and I in the kernel report's keys
    ("replaces" names the JAX package's function: neither has a TPU kernel)."""
    return json.dumps({"frontend": [
        {"name": name, "route": "cuda", "source": frontend.KERNELS[name][0],
         "replaces": frontend.KERNELS[name][1], "launches": launches[name], **rows[name]}
        for name in frontend.launch_counts]})


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
    args = (psi, tg, wg, tn, wn, taps, 0.1, 0.3, 32, -1.0)
    for name, K, levels in (("solver_16.npz", None, 1), ("solver_16_window.npz", 2, 1),
                            ("solver_16_pyramid.npz", 2, 2), ("solver_16_compositive.npz", 2, 1)):
        g = np.load(os.path.join(ROOT, "tests", "golden", name))
        if "compositive" in name:
            res = solver.estimate_psi_compositive(*args, warp_window=K, inverse_iters=8)
        else:
            res = solver.estimate_psi_pyramid(*args, levels=levels, inverse_iters=8,
                                              warp_window=K)
        e = max(
            float(np.abs(res.psi.cpu().numpy() - g["psi"]).max()),
            float(np.abs(res.tsdf_n_psi.cpu().numpy() - g["tnp"]).max()),
            float(np.abs(res.psi_inv.cpu().numpy() - g["psi_inv"]).max()),
        )
        log("goldens", f"{name}: max|d|={e:.3e} iters={res.iters}")
        check(e <= 1e-5 and res.iters == 32 * levels, f"{name}: port on the card disagrees")


def render_frames(params, n_frames, step, radius):
    """Depth frames (640x480, in memory) of a sphere of ``radius`` metres,
    0.8 m in front of the camera, translating ``step`` metres a frame in x."""
    render = tool("make_synthetic_scene").render_prims_depth
    intr = params.intr
    return [
        render(params.rows, params.cols, intr.fx, intr.fy, intr.cx, intr.cy,
               [((step * i, 0.0, 0.8), radius)])
        for i in range(n_frames)
    ]


def run_frames(torch, kernels, params, n_frames, phase, expect, step=0.006, radius=0.2,
               after=None):
    """Drive SobFusion on the card over n_frames of a sphere of ``radius``
    metres translating ``step`` metres a frame in the no-log loop; every
    kernel named in expect must launch. Each level's solve is timed on its own (a StageClock around
    solver.estimate_psi; an additive fine level's time includes its
    inverse, a compositive one's is the increment loop alone). after(i,
    fusion), if given, runs after each solve frame. Returns (launch counts
    of this path, the SobFusion)."""
    from sobfu_tpu_torch import mc, solver
    from sobfu_tpu_torch.ops import frontend
    from sobfu_tpu_torch.pipeline import SobFusion

    StageClock = tool("profile_torch_frame").StageClock
    frames = render_frames(params, n_frames, step, radius)
    fusion = SobFusion(params, device=DEVICE)
    fusion.need_inv_warps = False  # the no-log frame loop, as the CLI runs it
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    frontend.reset_launch_counts()
    max_reads = 0
    for i, depth in enumerate(frames):
        reads0 = sum(kernels.host_reads.values())
        e_reads0 = kernels.host_reads["gd_multi"]
        with StageClock((solver, "estimate_psi")) as clock:
            t0 = time.perf_counter()
            fusion(depth)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        res = fusion.last_solve if i >= max(1, params.start_frame) else None
        if res is None:
            log(phase, f"frame {i}: {dt:.4f} s (integrate only)")
            continue
        fine = res.iters - res.coarse_iters
        if res.max_norm <= params.max_update_norm:
            why = "converged"
        elif fusion.solver.stall_window and fine < params.max_iter:
            why = "data-energy stall"
        else:
            why = "MAX_ITER"
        levels = "; ".join(
            f"{'x'.join(map(str, shape[1:]))} level {out.iters} iters in {1e3 * sec:.4f} ms "
            f"({1e3 * sec / max(out.iters, 1):.4f} ms each)"
            for _, shape, out, sec in clock.calls
        )
        log(
            phase,
            f"frame {i}: {dt:.4f} s, iters {res.iters} (coarse {res.coarse_iters}, "
            f"fine {fine}), {sum(kernels.host_reads.values()) - reads0} host reads of the solve "
            f"loops ({kernels.host_reads['gd_multi'] - e_reads0} of them kernel E's), fine level "
            f"stopped on {why}, final max-norm "
            f"{res.max_norm:.6e}; {levels} (the coarsest first, the fine level last)",
        )
        max_reads = max(max_reads, sum(kernels.host_reads.values()) - reads0)
        # kernel E's loop: one read per GD_MULTI_LAUNCHES chunks of 16 on each coarse level
        e_cap = -(-params.max_iter // (16 * kernels.GD_MULTI_LAUNCHES))
        check(kernels.host_reads["gd_multi"] - e_reads0 <= max(0, params.pyramid_levels - 1) * e_cap,
              f"{phase}: kernel E's loop read the host more than once per "
              f"{kernels.GD_MULTI_LAUNCHES} chunks")
        if after is not None:
            after(i, fusion)
    counts = {**kernels.launch_counts, **frontend.launch_counts}
    mesh = mc.extract_mesh(
        fusion.phi_global.tsdf, fusion.phi_global.weight,
        fusion.phi_global.voxel_sizes(), pose=fusion.phi_global.pose,
    )
    torch.cuda.synchronize()
    log(phase, f"launch counts {counts}; the solve loops: host reads "
        f"{dict(kernels.host_reads)}, launches after the stop {dict(kernels.empty_launches)}; "
        f"phi_global mesh {mesh.n_triangles} triangles")
    # one read per chunk of GD_CHUNK iterations (and per stall check), not per iteration
    levels = max(1, params.pyramid_levels)
    check(max_reads <= levels * (params.max_iter // kernels.GD_CHUNK + 2),
          f"{phase}: {max_reads} host reads in a frame")
    for name in (*expect, *frontend.launch_counts):
        check(counts[name] > 0, f"{phase}: kernel {name} was never launched")
    state = (fusion.phi_global.tsdf, fusion.phi_global.weight, fusion.psi.data,
             fusion.psi_inv.data)
    check(all(bool(torch.isfinite(s).all()) for s in state), f"{phase}: non-finite state")
    dims = (3,) + fusion.phi_global.dims_zyx
    check(tuple(fusion.psi.data.shape) == dims, f"{phase}: psi shape")
    check(mesh.n_triangles > 0 and np.isfinite(mesh.vertices).all(), f"{phase}: empty mesh")
    return counts, fusion


def run_pyramid(torch, kernels, params, n_frames, phase, expect):
    """A pyramid path: the derived options, the frames, the half-res carry
    and its full-resolution materialisation. Returns its launch counts."""
    counts, fusion = run_frames(torch, kernels, params, n_frames, phase, expect)
    s = fusion.solver
    log(phase, f"solver: levels {s.pyramid_levels}, fused {s.fused}, inv_multigrid "
        f"{s.inv_multigrid}, inv_coarse {s.inv_coarse}, inverse_iters {s.inverse_iters}")
    check(s.pyramid_levels == params.pyramid_levels and s.fused and s.inv_multigrid
          and s.inv_coarse, f"{phase}: the solver did not derive the production options")
    dims = fusion.phi_global.dims_zyx
    half = (3,) + tuple(d // 2 for d in dims)
    check(tuple(fusion.psi_inv.data.shape) == half, f"{phase}: psi_inv is not carried half-res")
    full = fusion.full_res_inverse()
    check(tuple(full.shape) == (3,) + tuple(dims) and bool(torch.isfinite(full).all()),
          f"{phase}: the full-resolution inverse")
    mesh = fusion.get_phi_global_psi_inv_mesh()
    check(tuple(fusion.phi_global_psi_inv.tsdf.shape) == tuple(dims) and mesh.n_triangles > 0,
          f"{phase}: the psi_inv mesh getter")
    check(tuple(fusion.psi_inv.data.shape) == half, f"{phase}: the getter changed the carry")
    log(phase, f"psi_inv carried at {half[1:]}, materialised at {tuple(full.shape[1:])}; "
        f"phi_global o psi_inv mesh {mesh.n_triangles} triangles")
    return counts


def drift(torch, fusion, step, n_frames):
    """The drift measure of tests/test_pipeline.py:497-510 after n_frames
    frames of ``step`` metres: (band voxels, the accumulated drift in
    voxels, band-mean x and band-mean y displacement of psi over it), on the
    band |tsdf| < 0.5 with weight > 0."""
    from sobfu_tpu_torch import fields

    p = fusion.params
    total = step * (n_frames - 1) / (p.volume_size[0] / p.volume_dims[0])
    disp = fields.displacement(fusion.psi.data)
    band = (torch.abs(fusion.phi_global.tsdf) < 0.5) & (fusion.phi_global.weight > 0)
    return (int(band.sum()), total, float(disp[0][band].mean()) / total,
            float(disp[1][band].mean()) / total)


def run_compositive(torch, kernels, params, n_frames, step, expect, operands):
    """The compositive phase: the frames (the dict operands gets cloned
    copies of warp_field3's last operands: field, pos, K), then the drift
    check of
    tests/test_pipeline.py:497-510 — the accumulated motion exceeds K + 1
    voxels, the band-mean x displacement tracks more than 0.55 of it and
    the band-mean y stays under 0.25 of it. That bound was set on a sphere
    6.4 voxels in radius, so the sphere here is 0.05 m (6.4 voxels of 7.8
    mm); the 0.2 m sphere of the other phases (25.6 voxels) lags further
    behind its drift under the stall stop, as the JAX package's does
    (PERF.md §6, ``--probe``). Then the psi_inv mesh getter: the no-log
    loop keeps no inverse, so it computes the exact cold one (C) and the
    exact warps (B). Returns the launch counts of the frames and the
    getter."""
    field3 = kernels.warp_field3

    def keep(field, pos, K):
        operands.update(field=field.clone(), pos=pos.clone(), K=K)
        return field3(field, pos, K)

    with patched((kernels, "warp_field3", keep)):
        counts, fusion = run_frames(torch, kernels, params, n_frames, "compositive", expect,
                                    step, radius=0.05)
    s = fusion.solver
    log("compositive", f"solver: mode {s.mode}, levels {s.pyramid_levels}, fused {s.fused}, "
        f"warp_window {s.warp_window}, incremental_inverse {s.incremental_inverse}")
    check(s.mode == "compositive" and s.pyramid_levels == 2 and s.fused,
          "compositive: the solver did not derive the compositive options")
    n_band, total, rx, ry = drift(torch, fusion, step, n_frames)
    log("compositive", f"band of {n_band} voxels: mean dx / drift {rx:.4f}, mean dy / drift "
        f"{ry:.4f}; accumulated drift {total:.4f} voxels (K + 1 = {s.warp_window + 1})")
    check(n_band > 100 and total > s.warp_window + 1, "compositive: the drift is too small")
    check(rx > 0.55, "compositive: psi does not track the accumulated drift")
    check(abs(ry) < 0.25, "compositive: psi drifts sideways")

    kernels.reset_launch_counts()
    mesh = fusion.get_phi_global_psi_inv_mesh()
    torch.cuda.synchronize()
    refresh = dict(kernels.launch_counts)
    dims = (3,) + fusion.phi_global.dims_zyx
    inv = fusion.psi_inv.data
    log("compositive", f"psi_inv getter: launch counts {refresh}; psi_inv "
        f"{tuple(inv.shape[1:])}; phi_global o psi_inv mesh {mesh.n_triangles} triangles")
    check(tuple(inv.shape) == dims and bool(torch.isfinite(inv).all()),
          "compositive: the getter's psi_inv")
    check(mesh.n_triangles > 0, "compositive: empty psi_inv mesh")
    check(refresh["inverse_fixed_point"] > 0 and refresh["warp"] > 0,
          "compositive: the getter did not run C and B")
    return {k: counts[k] + refresh.get(k, 0) for k in counts}


# tools/bench_multiscene_stream.py's scenes: a 0.25 m volume 0.15 m in front
# of a 64x48 camera (fx = fy = 40), a 0.05 m sphere per scene, each
# drifting along its own direction (:98-100)
MULTISCENE_DIRS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0))


@functools.lru_cache(maxsize=None)
def stream_tool():
    """tools/bench_multiscene_stream_torch.py (its ray caster, render_dists,
    and its main), loaded once."""
    return tool("bench_multiscene_stream_torch")


def multiscene_stream(torch, S, n_frames):
    """tools/bench_multiscene_stream.py's configuration and stream at DIM^3
    for its first S scenes: (the frame step, the initial (psi, tg, wg,
    psi_inv), the depth batches of frames 0..n_frames, vol2cam, the step's
    scalars). The canonical is integrated from frame 0; scene s drifts
    min(0.9, 1.8 / n_frames) voxels a frame along its direction."""
    from sobfu_tpu_torch import fields, solver
    from sobfu_tpu_torch.parallel import make_frame_step
    from sobfu_tpu_torch.tsdf import integrate_dists

    dev = torch.device(DEVICE)
    dims = (DIM,) * 3
    size = 0.25
    vs = size / DIM
    trunc, eta = 8 * vs, 3 * vs
    H, W, f = 48, 64, 40.0
    intr = (f, f, W / 2 - 0.5, H / 2 - 0.5)
    taps = solver.sobolev_filter_1d(7, 0.1)
    step = make_frame_step(
        dims, inverse_iters=3, warp_window=2, fused=True, taps_static=tuple(taps),
        momentum=0.95, warm_inverse=True, pyramid_levels=2, stall_window=8, stall_rel=1e-2,
        fold_xmats=True, device=DEVICE,
    )
    vol2cam = np.eye(4, dtype=np.float32)
    vol2cam[:3, 3] = (-size / 2, -size / 2, 0.15)
    z_cam, r_sph = size / 2 + 0.15, 0.05
    zero = torch.zeros(dims, dtype=torch.float32, device=dev)
    render = stream_tool().render_dists
    d0 = torch.as_tensor(render(H, W, *intr, (0.0, 0.0, z_cam), r_sph), device=dev)
    tg1, wg1 = integrate_dists(zero, zero, d0, vol2cam, intr, (vs,) * 3, trunc, eta)
    psi1 = fields.identity_field(dims, device=dev)
    state = (psi1.expand(S, -1, -1, -1, -1).contiguous(), tg1.expand(S, -1, -1, -1).contiguous(),
             wg1.expand(S, -1, -1, -1).contiguous(), psi1.expand(S, -1, -1, -1, -1).contiguous())
    step_m = min(0.9, 1.8 / n_frames) * vs
    frames = [torch.as_tensor(np.stack([
        render(H, W, *intr, (d[0] * step_m * i, d[1] * step_m * i, z_cam), r_sph)
        for d in MULTISCENE_DIRS[:S]]), device=dev) for i in range(n_frames + 1)]
    scalars = (intr, (vs,) * 3, trunc, eta, 64.0, taps, 0.1, 0.2, 96, 1e-3)
    return step, state, frames, np.broadcast_to(vol2cam, (S, 4, 4)), scalars


def run_multiscene(torch, kernels, S, n_frames, phase):
    """The stream of S scenes through make_frame_step: a warm-up step on
    frame 0 whose output is dropped (as the tool's), then frames 1..n_frames
    with psi, tg, wg and psi_inv carried. Per frame: the seconds, each
    scene's coarse and fine iterations, and each level's batched loop timed
    on its own. Returns a dict: launch counts, the final state, the
    per-frame iterations and seconds, and what the profiled frame needs."""
    from sobfu_tpu_torch.parallel import sharding

    StageClock = tool("profile_torch_frame").StageClock
    step, state, frames, v2c, scalars = multiscene_stream(torch, S, n_frames)
    step(state[0], state[1], state[2], frames[0], v2c, *scalars, state[3])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    iters, secs, prev = [], [], state
    for i in range(1, n_frames + 1):
        prev = state
        reads0 = kernels.host_reads["gd_iteration_scenes"]
        with StageClock((sharding, "_gd_loop_scenes")) as clock:
            t0 = time.perf_counter()
            out = step(state[0], state[1], state[2], frames[i], v2c, *scalars, state[3])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        state = (out[0], out[2], out[3], out[1])
        coarse = step.coarse_iters
        fine = out[4].numpy() - coarse
        iters.append(out[4].numpy())
        secs.append(dt)
        levels = "; ".join(
            f"{'x'.join(map(str, shape[-3:]))} loop {int(res[2].max())} batched iterations in "
            f"{1e3 * sec:.4f} ms ({1e3 * sec / max(int(res[2].max()), 1):.4f} ms each)"
            for _, shape, res, sec in clock.calls)
        log(phase, f"frame {i}: {dt:.4f} s; coarse iterations {coarse.tolist()}, fine "
            f"{fine.tolist()}, {kernels.host_reads['gd_iteration_scenes'] - reads0} host reads; "
            f"{levels}")
    counts = dict(kernels.launch_counts)
    log(phase, f"{S} scenes x {n_frames} frames in {sum(secs):.4f} s: "
        f"{S * n_frames / sum(secs):.4f} scene-frames/s; launch counts {counts}; launches "
        f"after the stop {kernels.empty_launches['gd_iteration_scenes']}")
    return dict(counts=counts, state=state, iters=iters, secs=secs, step=step, prev=prev,
                last=(frames[n_frames], v2c, scalars))


def profile_step(torch, run, phase, kernel=None):
    """The last frame's step again, from the state before it, under
    torch.profiler: (wall seconds, device seconds). kernel: a tuple of
    names whose device time is printed apart (their profiler keys hold
    one of them)."""
    from torch.profiler import ProfilerActivity, profile

    device_us = tool("profile_torch_frame")._device_us
    state, (dists, v2c, scalars) = run["prev"], run["last"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run["step"](state[0], state[1], state[2], dists, v2c, *scalars, state[3])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = sorted(((device_us(e), e.count, e.key) for e in prof.key_averages()
                         if "CUDA" in str(getattr(e, "device_type", ""))), reverse=True)
    busy = sum(us for us, _, _ in per_kernel) * 1e-6
    log(phase, f"profiled last frame: {1e3 * wall:.4f} ms wall, {1e3 * busy:.4f} ms device, "
        f"busy {100 * busy / wall:.1f}%; the longest: " + "; ".join(
            f"{key[:40]} {us / 1e3:.4f} ms in {n}" for us, n, key in per_kernel[:5]))
    if kernel is not None:
        mine = [(us, n) for us, n, key in per_kernel if any(k in key for k in kernel)]
        log(phase, f"profiled last frame: {'/'.join(kernel)} {sum(u for u, _ in mine) / 1e3:.4f} "
            f"ms device in {sum(n for _, n in mine)} launches")
    return wall, busy


def tracking(torch, state, S, observed=False):
    """tools/bench_multiscene_stream.py:164-179: on each scene's band
    |tsdf| < 0.5 (at least 50 voxels) the mean displacement points along
    the scene's own direction (> 0.2 voxel) and its orthogonal part stays
    under 0.5 x that + 0.2. The tool's band is mostly free space (tsdf 0,
    never observed); observed=True narrows it to weight > 0, the surface.
    Returns [(band voxels, along, orthogonal, ok)]."""
    from sobfu_tpu_torch import fields

    out = []
    for s in range(S):
        disp = fields.displacement(state[0][s])
        band = torch.abs(state[1][s]) < 0.5
        if observed:
            band &= state[2][s] > 0
        n = int(band.sum())
        m = np.asarray([float(disp[c][band].mean()) for c in range(3)]) if n else np.zeros(3)
        d = np.asarray(MULTISCENE_DIRS[s], np.float64)
        proj = float(m @ d)
        orth = float(np.linalg.norm(m - proj * d))
        out.append((n, proj, orth, n >= 50 and proj > 0.2 and orth < 0.5 * abs(proj) + 0.2))
    return out


def run_multiscene_phase(torch, kernels, n_frames=6):
    """The multiscene phase: tools/bench_multiscene_stream.py's configuration
    at 128^3 with its four scenes, then scene 0 alone over the same frames.
    Checks: the path's kernels launched (A as gd_iteration_scenes only),
    scene 0 of the batch equal to scene 0 alone bit for bit (state and
    iterations of every frame), every scene tracking its own drift. Prints
    the scene-frames per second of both and the busy share of a profiled
    frame of each. Returns the launch counts of both runs."""
    S = len(MULTISCENE_DIRS)
    four = run_multiscene(torch, kernels, S, n_frames, "multiscene")
    one = run_multiscene(torch, kernels, 1, n_frames, "multiscene S=1")
    for name in ("gd_iteration_scenes", "warp", "inverse_fixed_point", "warp_fuse"):
        check(four["counts"][name] > 0 and one["counts"][name] > 0,
              f"multiscene: kernel {name} was never launched")
    check(four["counts"]["gd_iteration"] == 0, "multiscene: A ran unbatched")
    same = all(bitwise(a[0], b[0]) for a, b in zip(four["state"], one["state"])) and all(
        int(a[0]) == int(b[0]) for a, b in zip(four["iters"], one["iters"]))
    log("multiscene", f"scene 0 of the batch equals scene 0 alone bit for bit "
        f"(psi, tg, wg, psi_inv; iterations of every frame): {same}")
    check(same, "multiscene: scene 0 of the batch differs from scene 0 alone")
    rate4 = S * n_frames / sum(four["secs"])
    rate1 = n_frames / sum(one["secs"])
    log("multiscene", f"scene-frames/s: {rate4:.4f} with {S} scenes, {rate1:.4f} with 1 "
        f"(ratio {rate4 / rate1:.4f})")
    drift = min(0.9, 1.8 / n_frames) * n_frames  # voxels along each scene's direction
    for observed, band in ((False, "band"), (True, "observed band (weight > 0)")):
        for s, (n, proj, orth, ok) in enumerate(tracking(torch, four["state"], S, observed)):
            log("multiscene", f"scene {s} direction {MULTISCENE_DIRS[s]}: {band} {n} voxels, "
                f"mean displacement along it {proj:.4f} of a {drift:.2f}-voxel drift, "
                f"orthogonal {orth:.4f}: tracking {ok}")
            check(ok, f"multiscene: scene {s} does not track its drift on the {band}")
    shape = (S, 3) + (DIM,) * 3
    check(tuple(four["state"][0].shape) == shape and all(
        bool(torch.isfinite(x).all()) for x in four["state"]), "multiscene: the state")
    w4, b4 = profile_step(torch, four, "multiscene")
    w1, b1 = profile_step(torch, one, "multiscene S=1")
    log("multiscene", f"busy share under the profiler: {100 * b4 / w4:.1f}% with {S} scenes, "
        f"{100 * b1 / w1:.1f}% with 1")
    return [four["counts"], one["counts"]]


@contextlib.contextmanager
def patched(*triples):
    """Set each (object, attribute, value) for the with-block, then restore."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in triples]
    for obj, name, value in triples:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def run_cli(torch, kernels, argv, phase, viewer=None):
    """sobfu_tpu_torch.cli.main(argv) in this process, its launch counts
    zeroed just before it and read just after; a checkpoint load is timed
    and printed. Returns (its stdout, each frame's seconds as the CLI times
    them — the frame and a synchronise —, (seconds, bytes) of each
    checkpoint save, the launch counts)."""
    from sobfu_tpu_torch import cli
    from sobfu_tpu_torch.utils import checkpoint

    timers, saves, loads = [], [], []

    class Timer(cli.SampledScopeTime):
        def __init__(self):
            super().__init__()
            timers.append(self)

    save, load = checkpoint.save_checkpoint, checkpoint.load_checkpoint

    def timed_save(path, fusion):
        t0 = time.perf_counter()
        save(path, fusion)
        saves.append((time.perf_counter() - t0, os.path.getsize(path)))

    def timed_load(path, fusion):
        t0 = time.perf_counter()
        load(path, fusion)
        torch.cuda.synchronize()
        loads.append((time.perf_counter() - t0, os.path.getsize(path)))

    swaps = [(cli, "SampledScopeTime", Timer), (checkpoint, "save_checkpoint", timed_save),
             (checkpoint, "load_checkpoint", timed_load)]
    if viewer is not None:
        swaps.append((cli, "LiveViewer", viewer))
    out = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with patched(*swaps), contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    text = out.getvalue()
    for line in text.splitlines():
        log(phase, f"cli: {line}")
    for sec, size in loads:
        log(phase, f"checkpoint load {sec:.4f} s, {size} bytes")
    check(rc == 0, f"{phase}: the CLI exited {rc}")
    return text, [ms / 1e3 for ms in timers[0].samples_ms], saves, counts


def loader_check(text, no_native, phase):
    """The frame decoder the CLI reported; the native loader must have run
    wherever its library builds, unless --no-native-loader."""
    from sobfu_tpu_torch import native

    line = next(ln for ln in text.splitlines() if ln.startswith("frame decode:"))
    log(phase, f"{line}; native.available() {native.available()}")
    if native.available() and not no_native:
        check("native" in line, f"{phase}: the Python decoder ran where the native loader builds")


def decode_ms(depths, masks):
    """Per-frame decode milliseconds of the scene's depth: on the Python
    thread (--no-native-loader's decoder) and through the native prefetch
    loader (None where its library does not build)."""
    from sobfu_tpu_torch import io as sio
    from sobfu_tpu_torch import native

    py = []
    for j, path in enumerate(depths):
        t0 = time.perf_counter()
        d = sio.load_depth(path)
        if masks:
            d = sio.apply_mask(d, sio.load_mask(masks[j]))
        py.append(1e3 * (time.perf_counter() - t0))
    if not native.available():
        return py, None
    nat = []
    frames = iter(native.FrameLoader(depths, masks or None))
    for _ in depths:
        t0 = time.perf_counter()
        next(frames)
        nat.append(1e3 * (time.perf_counter() - t0))
    return py, nat


def same_checkpoints(a, b) -> bool:
    """Two .npz checkpoints with the same keys, dtypes, shapes and bits."""
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            and x[k].tobytes() == y[k].tobytes() for k in x.files)


def cli_resume(torch, kernels, root, phase):
    """Run (a): the production scene at 128^3, straight through and split
    3 + resume. Returns the launch counts of its three CLI runs."""
    import shutil

    from sobfu_tpu_torch import io as sio

    tool("make_synthetic_scene").main(
        [os.path.join(root, "A"), "--frames", "6", "--dim", str(DIM), "--production"])
    shutil.copytree(os.path.join(root, "A"), os.path.join(root, "B"))
    runs, texts = [], []
    for tag, argv in (
        ("A", ["--enable-log", "--checkpoint"]),
        ("B", ["--max-frames", "3", "--checkpoint"]),
        ("B", ["--enable-log", "--resume", os.path.join(root, "B.npz"), "--checkpoint"]),
    ):
        scene = os.path.join(root, tag)
        ck = os.path.join(root, f"{tag}.npz")
        text, secs, saves, counts = run_cli(
            torch, kernels,
            [scene, os.path.join(scene, "params.ini"), *argv, ck, "--device", DEVICE], phase)
        loader_check(text, False, phase)
        start = 3 if "--resume" in argv else 0
        for k, (sec, (save_s, size)) in enumerate(zip(secs, saves)):
            log(phase, f"{tag} frame {start + k}: {sec:.4f} s (CLI), checkpoint save "
                f"{save_s:.4f} s, {size} bytes")
        runs.append(counts)
        texts.append(text)
    check("resumed at frame 3" in texts[2], f"{phase}: the resumed run did not say "
          "'resumed at frame 3'")
    same = same_checkpoints(os.path.join(root, "A.npz"), os.path.join(root, "B.npz"))
    log(phase, f"6 frames straight and 3 + resume + 3 give the same checkpoint, key for key "
        f"and bit for bit: {same}")
    check(same, f"{phase}: the resumed run's checkpoint differs from the straight run's")
    last = [sio.load_mesh_vtk(os.path.join(root, t, "meshes", "mesh_0005.vtk")) for t in "AB"]
    fields = [sio.load_field_vti(os.path.join(root, t, "fields", "psi_0005.vti")) for t in "AB"]
    check(np.array_equal(last[0].vertices, last[1].vertices) and np.array_equal(*fields),
          f"{phase}: the resumed run's last mesh or field differs")
    log(phase, f"last logged mesh ({last[0].n_triangles} triangles) and field equal: True")
    with np.load(os.path.join(root, "A.npz")) as ck:
        # the ini has no key for the half-res carry (Solver.inv_coarse): full resolution
        check(ck["psi_inv"].shape == ck["psi"].shape == (3,) + (DIM,) * 3,
              f"{phase}: psi_inv {ck['psi_inv'].shape} is not carried at full resolution")
        log(phase, f"psi_inv carried at {ck['psi_inv'].shape[1:]} through the CLI")
    for name in ("gd_multi", "warp", "gd_iteration", "compose_weight", "inverse_fixed_point"):
        check(runs[0][name] > 0, f"{phase}: kernel {name} was never launched through the CLI")
    scene = os.path.join(root, "A")
    depths, _, masks = sio.list_frames(scene)
    py, nat = decode_ms(depths, masks)
    for j, ms in enumerate(py):
        log(phase, f"decode frame {j}: {ms:.4f} ms on the Python thread (--no-native-loader), "
            + ("native loader not available (its library does not build on this host)"
               if nat is None else f"{nat[j]:.4f} ms through the native prefetch loader"))
    return runs


def cli_half_res_checkpoint(torch, ini, root, phase):
    """The half-res carry across a checkpoint at 128^3: the fine_window
    phase's params (Solver.inv_coarse, which has no .ini key) through
    SobFusion and the checkpoint module, 3 frames + save + load + 3 frames
    against 6 straight. Prints the save and load seconds and the bytes."""
    from sobfu_tpu_torch.pipeline import SobFusion
    from sobfu_tpu_torch.utils import checkpoint

    params = tool("profile_torch_frame").production_params(ini, DIM, 2)
    params.fine_window = 1
    frames = render_frames(params, 6, 0.006, 0.2)

    def fresh():
        f = SobFusion(params, device=DEVICE)
        f.need_inv_warps = False  # the no-log loop, as the CLI runs it without viz
        return f

    straight, first, resumed = fresh(), fresh(), fresh()
    for d in frames:
        straight(d)
    for d in frames[:3]:
        first(d)
    path = os.path.join(root, "half_res.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(path, first)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.load_checkpoint(path, resumed)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for d in frames[3:]:
        resumed(d)
    a, b = checkpoint.state_dict(straight), checkpoint.state_dict(resumed)
    same = sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)
    log(phase, f"half-res carry: psi_inv {a['psi_inv'].shape}; 3 + save + load + 3 equals 6 "
        f"straight bit for bit: {same}; save {save_s:.4f} s, load {load_s:.4f} s, "
        f"{os.path.getsize(path)} bytes")
    check(a["psi_inv"].shape == (3,) + (DIM // 2,) * 3, f"{phase}: psi_inv is not half-res")
    check(same, f"{phase}: the resumed state differs from the straight run's")


def cli_visual(torch, kernels, root, phase):
    """Run (b): the visual flags on the production scene, 2 frames. The
    live viewer's /state.json is read after each update; every call of
    kernel C records its grid. Returns the run's launch counts."""
    import shutil
    import urllib.request

    from sobfu_tpu_torch import io as sio
    from sobfu_tpu_torch import viz
    from sobfu_tpu_torch.viewer import LiveViewer

    scene = os.path.join(root, "V")
    shutil.copytree(os.path.join(root, "A"), scene,
                    ignore=shutil.ignore_patterns("meshes", "fields"))
    argv = [scene, os.path.join(scene, "params.ini"), "--max-frames", "2", "--enable-log",
            "--color-mesh", "--live-viz", "--live-viz-port", "0", "--device", DEVICE]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    if has_mpl:
        argv.append("--enable-viz-detailed")
    else:
        log(phase, "matplotlib is not installed on this host: --enable-viz and "
            "--enable-viz-detailed are not run (tests/test_torch_viz.py and "
            "tests/test_torch_cli_io.py run them on the CPU)")
    served, grids, shots = [], [], []

    class Probed(LiveViewer):
        def update(self, *args, **kw):
            super().update(*args, **kw)
            url = f"http://127.0.0.1:{self.port}/state.json"
            with urllib.request.urlopen(url, timeout=30) as r:
                served.append(json.loads(r.read()))

    inverse, screenshot = kernels.inverse_fixed_point, viz.save_screenshot

    def recorded(psi, *args, **kw):
        grids.append(tuple(psi.shape[1:]))
        return inverse(psi, *args, **kw)

    def timed_shot(*args, **kw):
        t0 = time.perf_counter()
        screenshot(*args, **kw)
        shots.append(time.perf_counter() - t0)

    with patched((kernels, "inverse_fixed_point", recorded), (viz, "save_screenshot", timed_shot)):
        text, secs, _, counts = run_cli(torch, kernels, argv, phase, viewer=Probed)
    loader_check(text, False, phase)
    log(phase, f"frames {[round(s, 4) for s in secs]} s (CLI); screenshots {shots} s; "
        f"kernel C's grids {sorted(set(grids))}")
    mesh = sio.load_mesh_vtk(os.path.join(scene, "meshes", "mesh_0001.vtk"))
    check(mesh.colors is not None and mesh.colors.shape == mesh.vertices.shape,
          f"{phase}: the logged mesh carries no colours")
    check(served and [p["name"] for p in served[-1]["panels"]] == ["phi_global", "phi_n(psi)"]
          + (["phi_n", "phi_global(psi_inv)"] if has_mpl else []) and served[-1]["color"],
          f"{phase}: /state.json did not serve the panels")
    log(phase, f"/state.json served {len(served)} updates, panels "
        f"{[p['name'] for p in served[-1]['panels']]}, {len(served[-1]['panels'][0]['v']) // 9} "
        f"triangles in the first, a colour frame; coloured mesh {mesh.n_triangles} triangles")
    if has_mpl:
        check(os.path.exists(os.path.join(scene, "screenshots", "frame_0001.png")),
              f"{phase}: no screenshot")
    check((DIM,) * 3 in grids, f"{phase}: kernel C never ran at full resolution")
    return counts


def cli_gate(torch, kernels, root, phase):
    """Run (c): tools/validate_torch_cli_scene.py on the articulated scene,
    20 frames at 64^3 (the preset's compositive keys and NEW_SURFACE_GATE),
    budgets 2.2 / 1.5 voxels. Returns the run's launch counts."""
    gate = tool("validate_torch_cli_scene")
    out = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = gate.main([os.path.join(root, "G"), "--generate", "--frames", str(GATE_FRAMES),
                        "--dim", str(GATE_DIM), "--device", DEVICE])
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    lines = out.getvalue().strip().splitlines()
    for line in lines[:-1]:
        log(phase, f"cli: {line}")
    loader_check(out.getvalue(), False, phase)
    res = json.loads(lines[-1])
    rows = res["per_frame"]
    log(phase, "canonical RMSE (voxels) per frame: "
        f"{[r.get('rmse_canonical_vox') for r in rows]}")
    log(phase, f"live RMSE (voxels) per frame: {[r.get('rmse_live_vox') for r in rows]}")
    log(phase, f"budgets {res['budget_canonical_vox']} / {res['budget_live_vox']} voxels over "
        f"{res['frames']} logged frames: ok {res['ok']}; launch counts {counts}")
    check(rc == 0 and res["ok"], f"{phase}: the CLI gate failed")
    return counts


def run_cli_phase(torch, kernels, ini):
    """The cli phase: sobfu_tpu_torch.cli.main in this process on scenes
    written to a temporary directory, (a) resume, (b) the visual flags,
    (c) the gate. Returns the launch counts of its CLI runs."""
    import tempfile

    from sobfu_tpu_torch import native

    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "matplotlib")}
    log("cli", f"packages: {have}; native runtime: "
        + ("built" if native.available() else f"not built ({native._build_error})"))
    with tempfile.TemporaryDirectory(prefix="sobfu_cli_") as root:
        runs = cli_resume(torch, kernels, root, "cli")
        cli_half_res_checkpoint(torch, ini, root, "cli")
        runs.append(cli_visual(torch, kernels, root, "cli viz"))
        runs.append(cli_gate(torch, kernels, root, "cli gate"))
    return runs


def top_level_clock(*targets):
    """A StageClock that times only the calls not nested in another timed
    call, so that its stages add up to at most the frame."""

    class TopLevelClock(tool("profile_torch_frame").StageClock):
        depth = 0

        def _timed(self, name, fn):
            run = super()._timed(name, fn)

            def call(*args, **kw):
                if self.depth:
                    return fn(*args, **kw)
                self.depth += 1
                try:
                    return run(*args, **kw)
                finally:
                    self.depth -= 1

            return call

    return TopLevelClock(*targets)


def profile_cell(torch, params, step, radius, name, out, inv_warps=False):
    """Frames 0-3 of the scene warm up; frame 4 runs staged (each top-level
    stage timed on its own), frame 5 under torch.profiler; the inverse warps
    on where inv_warps (the logged loop: the incremental inverse and the
    exact tails), else off (the no-log loop). Returns the summary and writes
    the key_averages table under out."""
    from torch.profiler import ProfilerActivity, profile

    from sobfu_tpu_torch import pipeline, pyramid, solver
    from sobfu_tpu_torch.ops import kernels

    device_us = tool("profile_torch_frame")._device_us
    frames = render_frames(params, 6, step, radius)
    fusion = pipeline.SobFusion(params, device=DEVICE)
    fusion.need_inv_warps = inv_warps
    for depth in frames[:4]:
        fusion(depth)
    torch.cuda.synchronize()
    targets = ((pipeline, "preprocess"), (pipeline, "integrate_dists"),
               (solver, "estimate_psi"), (kernels, "warp"), (kernels, "warp_field3"),
               (kernels, "compose_weight"), (pyramid, "estimate_inverse_multigrid"))
    with top_level_clock(*targets) as clock:
        t0 = time.perf_counter()
        fusion(frames[4])
        torch.cuda.synchronize()
        staged = time.perf_counter() - t0
    stages = [{"stage": stage, "dims": list(shape[-3:]), "ms": 1e3 * sec,
               "iters": getattr(res, "iters", None)} for stage, shape, res, sec in clock.calls]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fusion(frames[5])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    per_kernel = {e.key: (device_us(e), e.count) for e in ka
                  if device_us(e) > 0 and "CUDA" in str(getattr(e, "device_type", ""))}
    busy = sum(us for us, _ in per_kernel.values()) * 1e-6
    with open(os.path.join(out, f"{name}_key_averages.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=40))
    summary = {
        "staged_frame_ms": 1e3 * staged,
        "stages": stages,
        "rest_ms": 1e3 * (staged - sum(sec for *_, sec in clock.calls)),
        "profiled_frame": {
            "wall_ms": 1e3 * wall, "device_ms": 1e3 * busy, "busy_share": busy / wall,
            "iters": fusion.last_solve.iters, "coarse_iters": fusion.last_solve.coarse_iters,
            "kernels": {k: {"device_ms": us / 1e3, "calls": n}
                        for k, (us, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])},
        },
    }
    log("probe", f"{name}: staged frame 4 {1e3 * staged:.4f} ms; "
        + "; ".join(f"{r['stage']} {r['dims']} {r['ms']:.4f} ms" for r in stages)
        + f"; profiled frame 5: {1e3 * wall:.4f} ms wall, {1e3 * busy:.4f} ms device, "
        f"busy {100 * busy / wall:.1f}%")
    return summary


def compositive_params(ini):
    """The compositive phase's keys: the umbrella ini + the drift keys of
    bench.py's compositive cell."""
    from sobfu_tpu_torch.config import load_params

    params = load_params(ini)
    params.solver_mode, params.warp_window, params.momentum = "compositive", 2, 0.9
    params.alpha, params.pyramid_levels, params.max_iter = 0.05, 2, 1024
    params.max_update_norm, params.stall_window, params.stall_rel = 4e-3, 16, 1e-2
    return params


def probe(torch, kernels, ini, out):
    """--probe: the drift witness at 128^3 and the profiles of the
    compositive and fine_window scenes (module docstring)."""
    os.makedirs(out, exist_ok=True)
    step = 0.009
    result = {"drift": {}, "profile": {}}
    for label, radius, fused, n_frames in (
        ("0.2 m", 0.2, True, 6), ("0.2 m, exact composition", 0.2, False, 6),
        ("0.1 m", 0.1, True, 6), ("0.05 m", 0.05, True, 6), ("0.2 m, 12 frames", 0.2, True, 12),
    ):
        params = compositive_params(ini)
        params.fused_pallas = fused
        ratios = []

        def after(i, fusion, ratios=ratios):
            ratios.append(drift(torch, fusion, step, i + 1)[2:])

        run_frames(torch, kernels, params, n_frames, f"probe {label}", (), step, radius, after)
        result["drift"][label] = [{"frame": i + 1, "dx": rx, "dy": ry}
                                  for i, (rx, ry) in enumerate(ratios)]
        log("probe", f"drift, sphere {label}: mean dx / drift by frame "
            + ", ".join(f"{rx:.4f}" for rx, _ in ratios) + f"; mean dy / drift {ratios[-1][1]:.4f}")
    result["profile"]["compositive"] = profile_cell(
        torch, compositive_params(ini), step, 0.05, "compositive", out)
    # the exact composition (warp_field3's exact form) and, with the inverse
    # warps on, the incremental inverse's exact sample
    params = compositive_params(ini)
    params.fused_pallas = False
    result["profile"]["compositive_exact"] = profile_cell(
        torch, params, step, 0.05, "compositive_exact", out, inv_warps=True)
    params = tool("profile_torch_frame").production_params(ini, DIM, 2)
    params.fine_window = 1
    result["profile"]["fine_window"] = profile_cell(torch, params, 0.006, 0.2, "fine_window", out)
    with open(os.path.join(out, "probe.json"), "w") as f:
        json.dump(result, f, indent=1)


# ---------------------------------------------------------------------------
# phase 13: the z-sharded solve and frame step on a mesh of one card
# ---------------------------------------------------------------------------


def slab_inputs(torch, d, n_z, K):
    """The operands of kernel A's slab form for each of n_z slabs of the
    whole-volume operands d (gd_inputs, with a scene axis): psi, tnp, vel and
    tg with their halo rows filled by the halo exchange, live the slab's halo
    form (or the whole volume for K None). Returns [(args, z_base, live_z0)]."""
    from sobfu_tpu_torch.parallel import zshard

    dev = d["psi"].device
    H = zshard.H
    devs = [dev] * n_z
    pad = {k: zshard._halo_exchange_z(zshard._split(d[k], devs), H)
           for k in ("psi", "tnp", "vel", "tg", "live")}
    Zl = d["tg"].shape[-3] // n_z
    out = []
    for j in range(n_z):
        live, lz0 = (d["live"], 0) if K is None else (pad["live"][j], j * Zl - H)
        out.append(((pad["psi"][j], pad["tnp"][j], pad["vel"][j], pad["tg"][j], live),
                    j * Zl, lz0))
    return out


def check_gd_slab(torch, kernels, solver):
    """Phase 13 (a): kernel A's slab form on CUDA tensors, each slab against
    its plain version (atol 1e-5 on the state, rtol 1e-5 on the norm and the
    energy) and against the whole-volume A launch bit for bit (psi', tnp',
    vel' of the slab's rows, the max norm over the slabs): 128^3, 7 taps,
    K=2, momentum 0.95 in 2, 4 and 8 slabs; the exact mode (live whole) and
    K=1 at 64^3 in 4 slabs; (12, 16, 20), K=2, 5 taps in 2 slabs. Then
    kernels.GdSlabLoop against kernels.GdLoop (check_gd_slab_loop) and the
    times at 128^3 / 4 slabs: an iteration of the loop (one card group: a
    launch an iteration, 16 a call), of the same loop with one group a slab
    (the first form's layout: a launch per slab and iteration, the halo rows
    copied), one slab a call, and the whole-volume A through GdLoop. One
    group launch at those shapes against its plain version on the group's
    inputs (atol 1e-5 on the state, rtol 1e-5 on the norm). Returns the
    report row: the group launch an iteration, its error the larger of that
    and the slabs', its bound over the rows it reads, the rest under
    "also"."""
    worst = 0.0
    for dims, n_taps, K, mu, splits in (((DIM,) * 3, 7, 2, 0.95, (2, 4, 8)),
                                        ((DIM // 2,) * 3, 7, None, 0.9, (4,)),
                                        ((DIM // 2,) * 3, 7, 1, None, (4,)),
                                        ((12, 16, 20), 5, 2, 0.9, (2,))):
        d = gd_inputs(torch, dims, 31, 1.8 if K else 3.5, scenes=1)
        taps = torch.as_tensor(solver.sobolev_filter_1d(n_taps, LAMBDA), device=d["psi"].device)
        whole = kernels.gd_iteration(*(d[k][0] for k in ("psi", "tnp", "vel", "tg", "live")),
                                     taps, 0.05, 0.2, mu, K)
        for n_z in splits:
            Zl = dims[0] // n_z
            bit, err, rel, mx = True, 0.0, 0.0, []
            for args, zb, lz0 in slab_inputs(torch, d, n_z, K):
                got = kernels.gd_iteration_slab(*args, taps, 0.05, 0.2, mu, K, zb, dims[0], lz0,
                                                with_energy=True)
                ref = kernels.gd_iteration_slab_plain(*args, taps, 0.05, 0.2, mu, K, zb, dims[0],
                                                      lz0, with_energy=True)
                err = max(err, max(max_abs(g, r) for g, r in zip(got[:3], ref[:3])))
                rel = max(rel, max(abs(float(g[0]) - float(r[0])) / max(abs(float(r[0])), 1e-30)
                                   for g, r in zip(got[3:], ref[3:])))
                rows = slice(zb, zb + Zl)
                bit = bit and bitwise(got[0][0], whole[0][:, rows]) and bitwise(
                    got[1][0], whole[1][rows]) and (mu is None or bitwise(got[2][0],
                                                                         whole[2][:, rows]))
                mx.append(float(got[3][0]))
            bit = bit and max(mx) == float(whole[3])
            log("sharded", f"gd_iteration_slab {'x'.join(map(str, dims))} taps={n_taps} K={K} "
                f"momentum={mu} in {n_z} slabs: max|d| from the plain version {err:.3e}, rel "
                f"d(max_sq, energy) {rel:.3e}; bit for bit with the whole-volume A launch {bit}")
            check(err <= 1e-5 and rel <= 1e-5, "gd_iteration_slab disagrees with its plain version")
            check(bit, "gd_iteration_slab differs from the whole-volume A launch")
            worst = max(worst, err)
    d = gd_inputs(torch, (DIM,) * 3, 31, 1.8, scenes=1)
    taps = torch.as_tensor(solver.sobolev_filter_1d(TAPS, LAMBDA), device=d["psi"].device)
    check_gd_slab_loop(torch, kernels, d, taps)
    # the times at 128^3 in 4 slabs, K=2, momentum 0.95, an iteration through
    # chunks of 16: the whole-volume A and the group in turns (A, group,
    # group, A, A, group), each from a fresh loop (a launch's time follows
    # the state it reaches), the median of each (the profiler now and then
    # records a part of a run's kernels), then the loop of one group a slab
    on = np.ones(1, bool)
    n = kernels.GD_CHUNK
    makers = {"whole": lambda: kernels.GdLoop("gd_iteration", d["psi"], d["tnp"], d["tg"],
                                              d["live"], taps, 0.05, 0.2, 0.95, 2, -1.0),
              "group": lambda: slab_loop(kernels, d, taps, 4, -1.0),
              "one group a slab": lambda: slab_loop(kernels, d, taps, 4, -1.0, per_slab=True)}
    turns = {label: [] for label in makers}
    for label in ("whole", "group", "group", "whole", "whole", "group", "one group a slab"):
        loop = makers[label]()
        t = {"ms": cuda_ms(lambda: loop.run(n, on), reps=4) / n,
             "device_ms": device_ms(lambda: loop.run(n, on), reps=4) / n}
        if label != "whole":
            t["calls_per_iteration"] = loop.calls / loop.iterations
            t["halo_bytes_per_iteration"] = loop.halo_bytes // loop.iterations
        turns[label].append(t)
    it = {label: {k: type(v)(np.median([t[k] for t in ts])) for k, v in ts[0].items()}
          for label, ts in turns.items()}
    whole = it["whole"]
    args, zb, lz0 = slab_inputs(torch, d, 4, 2)[1]
    call = (*args, taps, 0.05, 0.2, 0.95, 2, zb, DIM, lz0)
    one = timed(lambda: kernels.gd_iteration_slab(*call))
    one_plain = plain_ms(lambda: kernels.gd_iteration_slab_plain(*call))
    out = kernels.gd_iteration_slab(*call)
    one_row = row(worst, one, one_plain, slab_bytes(args, out, TAPS, 2, zb, DIM),
                  DIM // 4 * DIM * DIM * gd_ops(TAPS, True, True, False))
    # the group launch's plain version and bound: its buffers in, its own rows out
    g, H = makers["group"](), kernels.SLAB_HALO
    g_args = (*g.bufs[0][0], g.tg[0], g.live[0])
    g_call = (*g_args, taps, 0.05, 0.2, 0.95, 2, g.z_base[0], DIM, g.live_z0[0])
    plain = plain_ms(lambda: kernels.gd_iteration_slab_plain(*g_call))
    own = tuple(t[..., H:-H, :, :] for t in g.bufs[0][0])
    # one group launch at these shapes against its plain version on the same inputs
    ref = kernels.gd_iteration_slab_plain(*g_call)
    g_max = g.run(1, on)[1][0]
    g_state = [torch.cat(ts, dim=-3) for ts in zip(*g.state())]
    g_err = max(max_abs(a, b) for a, b in zip(g_state, ref[:3]))
    g_rel = float(abs(g_max[0] - ref[3][0].item()) / max(abs(ref[3][0].item()), 1e-30))
    log("sharded", f"gd_iteration_slab at 128^3 / 4 slabs, one group launch (4 slabs, K=2, "
        f"momentum 0.95): max|d| from the plain version {g_err:.3e}, rel d(max_sq) {g_rel:.3e}")
    check(g_err <= 1e-5 and g_rel <= 1e-5,
          "sharded (a): the group launch disagrees with its plain version")
    grp, per = it["group"], it["one group a slab"]
    log("sharded", "gd_iteration_slab at 128^3 / 4 slabs, K=2, momentum 0.95, an iteration, in "
        "turns (ms / device ms): the whole-volume A " + ", ".join(
            f"{t['ms']:.4f} / {t['device_ms']:.4f}" for t in turns["whole"]) + "; the group "
        + ", ".join(f"{t['ms']:.4f} / {t['device_ms']:.4f}" for t in turns["group"]))
    log("sharded", f"gd_iteration_slab at 128^3 / 4 slabs, K=2, momentum 0.95, an iteration: "
        f"GdSlabLoop as one card group {grp['ms']:.4f} ms, {grp['device_ms']:.4f} ms device, "
        f"{grp['calls_per_iteration']:.4f} kernel calls and {grp['halo_bytes_per_iteration']} "
        f"halo bytes an iteration (plain {plain:.4f} ms); as one group a slab {per['ms']:.4f} "
        f"ms, {per['device_ms']:.4f} ms device, {per['calls_per_iteration']:.4f} calls and "
        f"{per['halo_bytes_per_iteration']} halo bytes an iteration; one slab a call "
        f"{one['ms']:.4f} ms, {one['device_ms']:.4f} ms device (plain {one_plain:.4f} ms); the "
        f"whole-volume A through GdLoop {whole['ms']:.4f} ms, {whole['device_ms']:.4f} ms "
        f"device (medians of the turns); the group over the whole-volume A: "
        f"{grp['device_ms'] / whole['device_ms']:.4f}x device, {grp['ms'] / whole['ms']:.4f}x "
        "wall")
    check(grp["calls_per_iteration"] == 1 / n and grp["halo_bytes_per_iteration"] == 0,
          "sharded (a): the loop of one card group made more than one call a chunk or copied "
          "halo rows")
    report = row(max(worst, g_err), grp, plain,
                 slab_bytes(g_args, own, TAPS, 2, g.z_base[0], DIM),
                 DIM ** 3 * gd_ops(TAPS, True, True, False))
    report["also"] = {"one_slab_call": one_row, "gd_slab_loop_one_group_a_slab": per,
                      "gd_loop_whole_volume": whole,
                      "calls_per_iteration": grp["calls_per_iteration"]}
    return report


def slab_loop(kernels, d, taps, n_z, thresh, energy=False, per_slab=False, momentum=0.95):
    """kernels.GdSlabLoop over n_z slabs of the card of d (gd_inputs, one
    scene; the halo rows of tg and live filled by the halo exchange), K=2:
    one card group, or with per_slab card_groups patched to one group a
    slab (the first form's layout)."""
    from sobfu_tpu_torch.parallel import zshard

    devs = [d["psi"].device] * n_z
    groups = kernels.card_groups
    if per_slab:
        groups = lambda devices: [(j, j + 1) for j in range(len(devices))]  # noqa: E731
    with patched((kernels, "card_groups", groups)):
        return kernels.GdSlabLoop(
            zshard._split(d["psi"], devs), zshard._split(d["tnp"], devs),
            zshard._halo_exchange_z(zshard._split(d["tg"], devs), zshard.H),
            zshard._halo_exchange_z(zshard._split(d["live"], devs), zshard.H), taps, 0.05, 0.2,
            momentum, 2, thresh, DIM, energy=energy)


def check_gd_slab_loop(torch, kernels, d, taps):
    """Phase 13 (a): kernels.GdSlabLoop at DIM^3 in 2, 4 and 8 slabs of the
    card (one card group) and, as a check of the path between groups, the
    same forced into one group a slab, against kernels.GdLoop on the whole
    volume, K=2, in two runs: a chunk of 16 without momentum with a norm
    stop inside it (thresh a norm of the first 12 under all before it: the
    norms of momentum 0.95 rise over the first iterations), and two chunks
    of 16 with momentum 0.95 and no stop, the first with the energy. The
    iterations, the norm rows and psi, tnp and vel bit for bit; one launch
    per group and
    iteration that ran; one call and one host read a chunk for one group.
    The energy is per slab (its tile partials and fixed-order sum over the
    slab's rows; the host sums the slabs): bit for bit between the two
    layouts, within rtol 1e-5 of GdLoop's whole-volume sum (another
    summation order)."""
    on = np.ones(1, bool)
    args = (d["psi"], d["tnp"], d["tg"], d["live"], taps, 0.05, 0.2)
    norms = np.sqrt(kernels.GdLoop("gd_iteration", *args, None, 2, -1.0).run(16, on)[1][:, 0])
    j = max(k for k in range(12) if k == 0 or norms[k] < norms[:k].min())
    runs = {"stop": (None, float(norms[j]), (False,)), "energy": (0.95, -1.0, (True, False))}

    def drive(loop, chunks):
        kernels.reset_launch_counts()
        got = [loop.run(16, on, with_energy=e) for e in chunks]
        return got, dict(kernels.launch_counts), dict(kernels.empty_launches), \
            kernels.host_reads["gd_iteration_slab"]

    want = {}
    for name, (mu, thresh, chunks) in runs.items():
        whole = kernels.GdLoop("gd_iteration", *args, mu, 2, thresh, energy=True)
        want[name] = ([whole.run(16, on, with_energy=e) for e in chunks], whole.state())
    for n_z in (2, 4, 8):
        energies, msg = [], []
        for per_slab in (False, True):
            for name, (mu, thresh, chunks) in runs.items():
                loop = slab_loop(kernels, d, taps, n_z, thresh, True, per_slab, mu)
                got, counts, empty, reads = drive(loop, chunks)
                (w_chunks, w_state), groups = want[name], len(loop.groups)
                ran = sum(int(w[0][0]) for w in w_chunks)
                bit = all(g[0].tolist() == w[0].tolist() and np.array_equal(g[1], w[1])
                          for g, w in zip(got, w_chunks))
                bit = bit and all(bitwise(torch.cat([s[k] for s in loop.state()], dim=-3), w)
                                  for k, w in enumerate(w_state) if w is not None)
                counted = (counts["gd_iteration_slab"] == groups * ran
                           and empty["gd_iteration_slab"] == groups * (16 * len(chunks) - ran)
                           and reads == len(chunks))
                if name == "energy":
                    energies.append(got[0][2])
                msg.append(f"{groups} group(s), {name} ({ran} iterations): bit for bit {bit}, "
                           f"{loop.calls} calls, launches {counts['gd_iteration_slab']}, empty "
                           f"{empty['gd_iteration_slab']}, halo bytes {loop.halo_bytes}")
                check(bit, f"sharded (a): GdSlabLoop in {n_z} slabs, {groups} group(s), "
                      "differs from GdLoop on the whole volume")
                check(counted and (groups > 1 or loop.calls == len(chunks)),
                      f"sharded (a): GdSlabLoop in {n_z} slabs miscounted its launches or calls")
        e_whole = float(want["energy"][0][0][2][0])
        rel = abs(float(energies[0][0]) - e_whole) / abs(e_whole)
        same = energies[0].tobytes() == energies[1].tobytes()
        log("sharded", f"(a) GdSlabLoop {DIM}^3 in {n_z} slabs against GdLoop, the stop at "
            f"iteration {j + 1}: " + "; ".join(msg) + f"; energy {float(energies[0][0]):.9e}, "
            f"the same bits in both layouts {same}, rel d from GdLoop's {rel:.3e}")
        check(same and rel <= 1e-5, "sharded (a): GdSlabLoop's energy disagrees")


def slab_bytes(args, out, n_taps, K, z_base, z_global) -> int:
    """The bytes one launch of A's slab form must move: the rows it reads —
    psi and tnp at the dU positions (its own rows and r = n_taps // 2 on
    either side) and one row beyond for the differences; tg at the dU
    positions; vel at its own rows (with momentum); live its own rows and K
    on either side (the whole volume for the exact warp, K None), each
    clamped into the z_global-deep volume — and its own-row outputs. The
    halo rows the buffers hold past these are never read."""
    from sobfu_tpu_torch.parallel import zshard

    psi, tnp, vel, tg, live = args
    S, _, rows, Y, X = psi.shape
    Zl, r = rows - 2 * zshard.H, n_taps // 2

    def span(h: int) -> int:  # rows [z_base - h, z_base + Zl + h) inside the volume
        return min(z_base + Zl + h, z_global) - max(z_base - h, 0)

    read = 4 * span(r + 1) + span(r) + (3 * Zl if out[2] is not None else 0)
    read += live.shape[-3] if K is None else span(K)
    return S * Y * X * psi.element_size() * read + nbytes(*out[:3])


def sphere_pair(torch, dims, shift_vox):
    """(psi, tg, wg, tn, wn) on the card: tests/test_sharding.py's scene at
    dims, the live sphere moved along -x by shift_vox voxels."""
    from sobfu_tpu_torch import fields
    from sobfu_tpu_torch.tsdf import init_sphere

    dev = torch.device(DEVICE)
    size = 0.125
    vs = size / dims[2]
    c = size / 2
    radius = 0.01 * dims[2] / 32  # the test's 0.01 m at 32^3, scaled with the grid
    tg, wg = init_sphere(dims, (vs,) * 3, (c, c, c), radius, 10 * vs, 2 * vs, device=dev)
    tn, wn = init_sphere(dims, (vs,) * 3, (c - shift_vox * vs, c, c), radius, 10 * vs, 2 * vs,
                         device=dev)
    return fields.identity_field(dims, device=dev), tg, wg, tn, wn


def sharded_counts(kernels, phase, counts):
    """Only A's slab form ran on the sharded path."""
    log(phase, f"launch counts {counts}; host reads {kernels.host_reads['gd_iteration_slab']}, "
        f"launches after the stop {kernels.empty_launches['gd_iteration_slab']}")
    check(counts["gd_iteration_slab"] > 0, f"{phase}: kernel gd_iteration_slab was never launched")
    others = {k: v for k, v in counts.items() if k != "gd_iteration_slab" and v}
    check(not others, f"{phase}: the sharded path launched {others}")


def check_sharded_solve(torch, kernels, solver):
    """Phase 13 (b): make_sharded_estimate_psi on make_mesh(n_z=4,
    devices=[cuda]*4) at 128^3 in the production keys (fused, momentum 0.9,
    warm inverse, K=2, 7 taps; 40 iterations) against solver.estimate_psi on
    the card (the bounds of test_sharded_production_config_matches_single_
    chip); then pyramid_levels=2 against solver.estimate_psi_pyramid (the
    seam bounds of test_sharded_pyramid_seam_cost_bounded), then
    fine_window=1. Returns the launch counts of the sharded runs."""
    from sobfu_tpu_torch.parallel import make_mesh, make_sharded_estimate_psi

    dev = torch.device(DEVICE)
    dims = (DIM,) * 3
    taps = solver.sobolev_filter_1d(TAPS, LAMBDA)
    mesh = make_mesh(n_z=4, devices=[dev] * 4)
    psi, tg, wg, tn, wn = sphere_pair(torch, dims, 1.5)
    args = (0.1, 0.4, 40, -1.0)
    ref = solver.estimate_psi(psi, tg, wg, tn, wn, taps, *args, inverse_iters=48, warp_window=2,
                              momentum=0.9)
    fn = make_sharded_estimate_psi(mesh, inverse_iters=12, warp_window=2, fused=True,
                                   taps_static=tuple(taps), momentum=0.9, warm_inverse=True)
    fn(psi, tg, wg, tn, wn, taps, *args, ref.psi_inv)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    mesh.reset_counts()
    t0 = time.perf_counter()
    out = fn(psi, tg, wg, tn, wn, taps, *args, ref.psi_inv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = [dict(kernels.launch_counts)]
    d_psi, d_tnp = max_abs(out[0], ref.psi), max_abs(out[2], ref.tsdf_n_psi)
    d_inv = max_abs(out[1], ref.psi_inv)
    rel = abs(float(out[7]) - ref.max_norm) / ref.max_norm
    log("sharded", f"(b) 128^3 on 4 slabs, fused, momentum 0.9, warm inverse, K=2: {dt:.4f} s; "
        f"iterations {int(out[6])} / {ref.iters} unsharded; max|d psi| {d_psi:.3e}, max|d tnp| "
        f"{d_tnp:.3e}, rel d(max norm) {rel:.3e}, max|d psi_inv| {d_inv:.3e}; halo bytes "
        f"{mesh.halo_bytes} ({mesh.loop_halo_bytes // max(mesh.loop_iterations, 1)} an "
        f"iteration of the loop), whole-volume gathers {mesh.gathers}")
    sharded_counts(kernels, "sharded (b)", counts[-1])
    check(int(out[6]) == ref.iters and d_psi <= 2e-5 and d_tnp <= 2e-5 and rel <= 1e-4
          and d_inv <= 0.05, "sharded (b): the sharded solve disagrees with the unsharded one")
    check(mesh.gathers == 0, "sharded (b): the windowed solve gathered a whole volume")

    # the pyramid: seams against the single-device pyramid (JAX's test runs
    # 256 fine iterations at 32^3; a 128^3 fine level needs more to converge)
    psi, tg, wg, tn, wn = sphere_pair(torch, dims, 2.0)
    max_iter = 1024
    args = (0.1, 0.3, max_iter, 2e-3)
    opts = dict(warp_window=3, momentum=0.9, inverse_iters=2)
    ref = solver.estimate_psi_pyramid(psi, tg, wg, tn, wn, taps, *args, levels=2,
                                      coarse_max_iter=12, **opts)
    kernels.reset_launch_counts()
    shd = make_sharded_estimate_psi(mesh, pyramid_levels=2, coarse_max_iter=12, fused=True,
                                    taps_static=tuple(taps), **opts)(psi, tg, wg, tn, wn, taps,
                                                                     *args)
    counts.append(dict(kernels.launch_counts))
    e_ref = float(solver.data_energy(tg, ref.tsdf_n_psi))
    e_shd = float(solver.data_energy(tg, shd[2]))
    log("sharded", f"(b) pyramid 2 levels, K=3, coarse cap 12, thresh 2e-3, MAX_ITER "
        f"{max_iter}: iterations {int(shd[6])} sharded / {ref.iters} single-device (bound: "
        f"within {max(4, int(0.15 * ref.iters))}; the fine level converged: sharded "
        f"{int(shd[6]) < max_iter + 12}, single-device {ref.iters < max_iter + 12}); data "
        f"energy {e_shd:.6e} / {e_ref:.6e} (ratio {e_shd / e_ref:.4f}, bound 1.05)")
    sharded_counts(kernels, "sharded (b) pyramid", counts[-1])
    check(int(shd[6]) < max_iter + 12 and ref.iters < max_iter + 12,
          "sharded (b): a pyramid's fine level ran to MAX_ITER without converging")
    check(abs(int(shd[6]) - ref.iters) <= max(4, int(0.15 * ref.iters))
          and e_shd <= e_ref * 1.05 + 1e-6, "sharded (b): the pyramid's seams cost too much")

    # fine_window: the compositive fine level from a smooth sub-voxel psi0
    # (tests/test_sharding.py's: it plays the upsampled coarse field)
    psi, tg, wg, tn, wn = sphere_pair(torch, dims, 1.5)
    zz = torch.linspace(0.0, np.pi, DIM, device=dev)
    psi = psi + 0.6 * torch.sin(zz)[None, :, None, None]
    args = (0.1, 0.4, 40, -1.0)
    ref = solver.estimate_psi_compositive(psi, tg, wg, tn, wn, taps, *args, None,
                                          inverse_iters=8, warp_window=1, total_window=2,
                                          momentum=0.9)
    kernels.reset_launch_counts()
    shd = make_sharded_estimate_psi(mesh, inverse_iters=8, warp_window=2, fine_window=1,
                                    momentum=0.9, fused=True, taps_static=tuple(taps))(
        psi, tg, wg, tn, wn, taps, *args)
    counts.append(dict(kernels.launch_counts))
    d_psi, d_tnp = max_abs(shd[0], ref.psi), max_abs(shd[2], ref.tsdf_n_psi)
    # psi holds absolute coordinates: 8 ulps of the largest (tests/test_sharding.py
    # holds 2e-5 at 32^3, 10.5 of its ulps). The first slab's coordinates
    # shifted by +K into its halo frame (_sample_window_local) round where
    # they cross a power of two; the other slabs' shifts are exact.
    bound = 8 * float(np.spacing(np.float32(DIM - 1)))
    log("sharded", f"(b) fine_window=1: iterations {int(shd[6])} / {ref.iters} single-device "
        f"compositive; max|d psi| {d_psi:.3e} (bound {bound:.3e}), max|d tnp| {d_tnp:.3e}")
    sharded_counts(kernels, "sharded (b) fine_window", counts[-1])
    check(int(shd[6]) == ref.iters and d_psi <= bound and d_tnp <= 2e-5,
          "sharded (b): the fine_window solve disagrees with the single-device compositive one")
    return counts


# phase 13's grids: the parity with the one-device step, the drifting pair,
# the frame on 8 slabs
PARITY_DIM, DRIFT_DIM, BIG_DIM = 64, 256, 512
# __graft_entry__.py's dry-run configuration (fold_xmats picks a TPU layout)
DRYRUN = dict(inverse_iters=4, warp_window=2, fused=True, momentum=0.95, warm_inverse=True,
              pyramid_levels=2, stall_window=8, stall_rel=1e-2, fold_xmats=True,
              axis_aligned=True)


def parity_scenes(torch, dims, S):
    """__graft_entry__.py's parity data at dims: per scene a sphere of 0.06
    m a little off centre as the canonical, weights 1, and a sloped wall of
    depth in front of a 64x48 camera; (state, dists, vol2cam, scalars)."""
    from sobfu_tpu_torch import fields, solver
    from sobfu_tpu_torch.tsdf import init_sphere

    dev = torch.device(DEVICE)
    size = 0.25
    vs = size / dims[2]
    trunc, eta = 10 * vs, 2 * vs
    c = size / 2
    tg = torch.stack([init_sphere(dims, (vs,) * 3, (c - (0.5 + 0.5 * s) * vs, c, c), 0.06, trunc,
                                  eta, device=dev)[0] for s in range(S)])
    H, W = 48, 64
    uu = np.arange(W, dtype=np.float32)[None, :] / W
    dists1 = 0.28 + 0.08 * uu * np.ones((H, 1), np.float32)
    dists = torch.as_tensor(np.stack([dists1 + 0.01 * s for s in range(S)]), device=dev)
    v2c = np.eye(4, dtype=np.float32)
    v2c[:3, 3] = (-size / 2, -size / 2, 0.2)
    psi = fields.identity_field(dims, device=dev).expand(S, -1, -1, -1, -1).contiguous()
    state = (psi, tg, torch.ones_like(tg), psi.clone())
    scalars = ((40.0, 40.0, W / 2, H / 2), (vs,) * 3, trunc, eta, 64.0,
               solver.sobolev_filter_1d(7, 0.1), 0.05, 0.2, 8, -1.0)
    return state, dists, np.broadcast_to(v2c, (S, 4, 4)), scalars


def drifting_pair(torch, dims, n_frames):
    """Two scenes at dims: multiscene_stream's camera and 0.05 m sphere,
    scene 0 drifting +x and scene 1 +y by 0.6 voxel a frame; (state, the
    depth batches of frames 0..n_frames, vol2cam, scalars)."""
    from sobfu_tpu_torch import fields, solver
    from sobfu_tpu_torch.tsdf import integrate_dists

    dev = torch.device(DEVICE)
    size = 0.25
    vs = size / dims[2]
    trunc, eta = 8 * vs, 3 * vs
    H, W, f = 48, 64, 40.0
    intr = (f, f, W / 2 - 0.5, H / 2 - 0.5)
    vol2cam = np.eye(4, dtype=np.float32)
    vol2cam[:3, 3] = (-size / 2, -size / 2, 0.15)
    z_cam, r_sph = size / 2 + 0.15, 0.05
    zero = torch.zeros(dims, dtype=torch.float32, device=dev)
    render = stream_tool().render_dists
    d0 = torch.as_tensor(render(H, W, *intr, (0.0, 0.0, z_cam), r_sph), device=dev)
    tg1, wg1 = integrate_dists(zero, zero, d0, vol2cam, intr, (vs,) * 3, trunc, eta)
    psi1 = fields.identity_field(dims, device=dev)
    state = (psi1.expand(2, -1, -1, -1, -1).contiguous(), tg1.expand(2, -1, -1, -1).contiguous(),
             wg1.expand(2, -1, -1, -1).contiguous(), psi1.expand(2, -1, -1, -1, -1).contiguous())
    step = 0.6 * vs
    frames = [torch.as_tensor(np.stack([
        render(H, W, *intr, (d[0] * step * i, d[1] * step * i, z_cam), r_sph)
        for d in ((1, 0), (0, 1))]), device=dev) for i in range(n_frames + 1)]
    scalars = (intr, (vs,) * 3, trunc, eta, 64.0, solver.sobolev_filter_1d(7, 0.1), 0.1, 0.2,
               96, 1e-3)
    return state, frames, np.broadcast_to(vol2cam, (2, 4, 4)), scalars


def check_sharded_frame_step(torch, kernels):
    """Phase 13 (c): make_frame_step over a (2 scene x 4 z) mesh of one card.
    At 64^3, 4 scenes, 8 iterations, __graft_entry__.py's parity data, in
    the configuration of its parity check (the dry-run configuration with
    one pyramid level and no stall stop) against the one-device
    make_frame_step on the card: max |d psi|, |d tsdf| and |d psi_inv|
    under 1e-5, printed beside MULTICHIP_r05.json's 0 / 0 / 5.96e-8 (JAX's
    sharded step against its single-chip solve). Then the dry-run
    configuration itself (2 levels, stall 8): the sharded pyramid upsamples
    per slab, so its seams' differences from the one-device step are
    printed, not bounded (the CPU tests hold it to JAX's sharded step); it is
    held to the same (2 x 4) mesh on CPU devices (the slab form's plain
    version) instead: equal iterations, psi and psi_inv within 8 ulps of the
    largest coordinate, tsdf and weight within 1e-5. Then at 256^3, 2 scenes drifting
    +x and +y, 3 frames after a warm-up frame: per frame the seconds, the
    iterations per level and scene, the host reads, the halo bytes per
    iteration; a profiled frame's busy share and the peak memory. Returns
    the launch counts of the sharded runs."""
    from sobfu_tpu_torch.parallel import make_frame_step, make_mesh

    dev = torch.device(DEVICE)
    mesh = make_mesh(n_z=4, n_scene=2, devices=[dev] * 8)
    dims = (PARITY_DIM,) * 3
    state, dists, v2c, scalars = parity_scenes(torch, dims, 4)
    taps_static = tuple(scalars[5])
    counts = []
    for label, cfg in (("the parity configuration (1 level, no stall)",
                        dict(DRYRUN, pyramid_levels=1, stall_window=0)),
                       ("the dry-run configuration (2 levels, stall 8)", DRYRUN)):
        one = make_frame_step(dims, device=DEVICE, taps_static=taps_static, **cfg)
        want = one(*state[:3], dists, v2c, *scalars, state[3])
        shd = make_frame_step(dims, mesh=mesh, taps_static=taps_static, **cfg)
        kernels.reset_launch_counts()
        got = shd(*state[:3], dists, v2c, *scalars, state[3])
        torch.cuda.synchronize()
        counts.append(dict(kernels.launch_counts))
        d = [max_abs(got[k], want[k]) for k in (0, 2, 1)]
        log("sharded", f"(c) {'x'.join(map(str, dims))}, (2 x 4) mesh of one card, 4 scenes, 8 "
            f"iterations a level, {label}: iterations {got[4].tolist()} / {want[4].tolist()} "
            f"one-device; max|d psi| {d[0]:.3e}, max|d tsdf| {d[1]:.3e}, max|d psi_inv| "
            f"{d[2]:.3e} (MULTICHIP_r05.json, JAX's sharded step in the parity configuration "
            "against its single-chip solve: 0 / 0 / 5.96e-8)")
        sharded_counts(kernels, "sharded (c)", counts[-1])
        check(got[4].tolist() == want[4].tolist(), "sharded (c): the iterations differ")
        check(all(bool(torch.isfinite(x).all()) for x in got[:4]), "sharded (c): non-finite state")
        if cfg["pyramid_levels"] == 1:
            check(max(d) <= 1e-5,
                  "sharded (c): the sharded frame step disagrees with the one-device step")
            continue
        # the dry-run configuration against the same (2 x 4) mesh on CPU
        # devices: the same seams, the plain version of the slab form. The
        # pyramid's resamples (a mean over 2x2x2 cells, the trilinear
        # upsample's matrix products) sum in another order on the card, so
        # psi and psi_inv, which hold absolute coordinates, are held to 8
        # ulps of the largest (3-4 measured at 64^3); tsdf and weight to 1e-5
        cpu = make_frame_step(dims, mesh=make_mesh(n_z=4, n_scene=2, devices=["cpu"] * 8),
                              taps_static=taps_static, **cfg)
        t0 = time.perf_counter()
        ref = cpu(*(x.cpu() for x in state[:3]), dists.cpu(), v2c, *scalars, state[3].cpu())
        dt = time.perf_counter() - t0
        e = [max_abs(got[k].cpu(), ref[k]) for k in (0, 2, 1, 3)]
        ulps = 8 * float(np.spacing(np.float32(PARITY_DIM - 1)))
        log("sharded", f"(c) {label} against the same mesh on CPU devices ({dt:.2f} s): "
            f"iterations {ref[4].tolist()}; max|d psi| {e[0]:.3e}, max|d psi_inv| {e[2]:.3e} "
            f"(bound {ulps:.3e}), max|d tsdf| {e[1]:.3e}, max|d weight| {e[3]:.3e} (bound 1e-5)")
        check(got[4].tolist() == ref[4].tolist() and max(e[0], e[2]) <= ulps
              and max(e[1], e[3]) <= 1e-5,
              "sharded (c): the sharded frame step on the card disagrees with the CPU mesh")

    dims = (DRIFT_DIM,) * 3
    n_frames = 3
    state, frames, v2c, scalars = drifting_pair(torch, dims, n_frames)
    step = make_frame_step(dims, mesh=mesh, taps_static=taps_static, **DRYRUN)
    step(*state[:3], frames[0], v2c, *scalars, state[3])  # warm-up, dropped
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for i in range(1, n_frames + 1):
        prev = state
        mesh.reset_counts()
        reads0 = kernels.host_reads["gd_iteration_slab"]
        t0 = time.perf_counter()
        out = step(*state[:3], frames[i], v2c, *scalars, state[3])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        state = (out[0], out[2], out[3], out[1])
        log("sharded", f"(c) {DRIFT_DIM}^3 frame {i}: {secs[-1]:.4f} s; coarse iterations "
            f"{step.coarse_iters.tolist()}, fine {(out[4].numpy() - step.coarse_iters).tolist()}; "
            f"{kernels.host_reads['gd_iteration_slab'] - reads0} host reads; halo bytes "
            f"{mesh.halo_bytes} ({mesh.loop_halo_bytes // max(mesh.loop_iterations, 1)} an "
            f"iteration of the loops over {mesh.loop_iterations} iterations); whole-volume "
            f"gathers {mesh.gathers}")
    counts.append(dict(kernels.launch_counts))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("sharded", f"(c) {DRIFT_DIM}^3: {2 * n_frames / sum(secs):.4f} scene-frames/s, peak memory "
        f"{peak:.3f} GiB")
    sharded_counts(kernels, f"sharded (c) {DRIFT_DIM}^3", counts[-1])
    check(all(bool(torch.isfinite(x).all()) for x in state), "sharded (c): non-finite state")
    run = dict(step=step, prev=prev, last=(frames[n_frames], v2c, scalars))
    profile_step(torch, run, f"sharded (c) {DRIFT_DIM}^3",
                 kernel=("gd_fused_kernel", "energy_partials_kernel", "energy_final_kernel"))
    return counts


def check_sharded_512(torch, kernels):
    """Phase 13 (d): one frame at 512^3 on make_mesh(n_z=8, devices=[cuda]*8),
    windowed, in the dry-run configuration with MAX_ITER 32 a level (the
    multiscene camera and sphere, one scene): the seconds, the iterations,
    the peak memory and the whole-volume gathers, which must be 0. Returns
    its launch counts."""
    from sobfu_tpu_torch.parallel import make_frame_step, make_mesh

    dev = torch.device(DEVICE)
    dims = (BIG_DIM,) * 3
    mesh = make_mesh(n_z=8, devices=[dev] * 8)
    state, frames, v2c, scalars = drifting_pair(torch, dims, 1)
    state = tuple(x[:1] for x in state)
    scalars = scalars[:8] + (32,) + scalars[9:]
    step = make_frame_step(dims, mesh=mesh, taps_static=tuple(scalars[5]), **DRYRUN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(*state[:3], frames[1][:1], v2c[:1], *scalars, state[3])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("sharded", f"(d) {BIG_DIM}^3 on 8 slabs of one card, one frame: {dt:.4f} s; iterations "
        f"{out[4].tolist()} (coarse {step.coarse_iters.tolist()}); peak memory {peak:.3f} GiB; "
        f"whole-volume gathers {mesh.gathers}; halo bytes {mesh.halo_bytes}")
    sharded_counts(kernels, "sharded (d)", counts)
    check(mesh.gathers == 0, "sharded (d): the windowed 512^3 frame gathered a whole volume")
    check(all(bool(torch.isfinite(x).all()) for x in out[:4]), "sharded (d): non-finite state")
    return [counts]


def run_sharded_phase(torch, kernels, solver):
    """Phase 13: (a) A's slab form, (b) the sharded solve, (c) the sharded
    frame step, (d) 512^3 on 8 slabs. Returns (A's slab form's report row,
    the launch counts of the sharded paths)."""
    slab_row = check_gd_slab(torch, kernels, solver)
    runs = check_sharded_solve(torch, kernels, solver)
    runs += check_sharded_frame_step(torch, kernels)
    runs += check_sharded_512(torch, kernels)
    return slab_row, runs


# phase 14: the scene (PERF.md §4 "kinfu"): a 0.3 m sphere on the optical
# axis in front of a wall, and two smaller spheres off the axis. Without them
# the scene is symmetric under a rotation about the axis through the big
# sphere's centre perpendicular to the wall, which no ICP can observe: on it
# frame-to-frame tracking drifts 1.73 degrees in roll over the 8 frames.
KINFU_SPHERES = (((0.0, 0.0, 1.5), 0.3), ((0.45, -0.3, 1.9), 0.15), ((-0.5, 0.35, 1.7), 0.12))
KINFU_WALL_Z = 2.5
KINFU_FRAMES = 8
KINFU_STEP_M, KINFU_YAW_DEG = 0.005, 0.2


def pose_error(est, true):
    """(translation error in mm, rotation error in degrees) of an estimated
    camera-to-world pose against the true one."""
    d = np.linalg.inv(np.asarray(true, np.float64)) @ np.asarray(est, np.float64)
    R = d[:3, :3]
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return 1e3 * float(np.linalg.norm(d[:3, 3])), float(np.degrees(np.arctan2(s, np.trace(R) - 1.0)))


class CallClock:
    """Host seconds of each call of wrapped callables, a synchronise on
    either side so that a call's device work is inside its time."""

    def __init__(self, torch):
        self.torch = torch
        self.secs = {}

    def wrap(self, name, fn):
        def run(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            self.secs.setdefault(name, []).append(time.perf_counter() - t0)
            return out

        return run

    def ms(self, name) -> str:
        s = self.secs.get(name, [])
        return f"{1e3 * np.mean(s):.4f} ms x {len(s)}" if s else "no call"


def raycast_steps(volume, pose, step) -> int:
    """Steps of ``step`` metres along camera z that reach the volume's far
    corner from ``pose`` (KinFu's own raycasts stop at 512)."""
    corners = np.array([[x, y, z, 1.0] for x in (0, 1) for y in (0, 1) for z in (0, 1)])
    corners[:, :3] *= np.asarray(volume.size)
    cam = (np.linalg.inv(np.asarray(pose, np.float64)) @ volume.pose.astype(np.float64)
           @ corners.T)
    return int(np.ceil(cam[2].max() / step)) + 1


def check_raycast_against_depth(torch, raycast, kinfu, pose_true, depth, phase):
    """A raycast of the fused volume from KinFu's last pose against the
    frame rendered at the true pose: of the pixels whose rendered surface
    lies inside the volume at least 90% must hit, and there the median
    |depth difference| must be under one voxel. Returns (hit share, median
    mm, the raycast's ms)."""
    p = kinfu.params()
    vol = kinfu.tsdf()
    vs = min(vol.voxel_sizes())
    step = float(np.float32(p.raycast_step_factor * vs))
    steps = raycast_steps(vol, kinfu.get_camera_pose(), step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _, _ = raycast.raycast_volume(vol, kinfu.get_camera_pose(), p.intr, p.rows, p.cols,
                                       p.raycast_step_factor, max_steps=steps)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    got = got.cpu().numpy()
    z = depth.astype(np.float64) * 1e-3
    fx, fy, cx, cy = p.intr
    u = np.arange(p.cols)[None, :]
    v = np.arange(p.rows)[:, None]
    cam = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z, np.ones_like(z)], axis=-1)
    vol_pts = cam @ (np.linalg.inv(vol.pose.astype(np.float64)) @ pose_true).T
    inside = (depth > 0) & np.all((vol_pts[..., :3] > 0) & (vol_pts[..., :3] < vol.size), -1)
    hit = inside & (got > 0)
    share = hit.sum() / max(inside.sum(), 1)
    med = float(np.median(np.abs(got[hit] - z[hit]))) if hit.any() else float("inf")
    log(phase, f"raycast of the fused volume from the last pose ({steps} steps, {ms:.4f} ms): "
        f"{hit.sum()} of {inside.sum()} in-volume pixels hit ({100 * share:.2f}%), median "
        f"|d depth| {1e3 * med:.4f} mm (one voxel {1e3 * vs:.4f} mm)")
    check(share >= 0.9, f"{phase}: the raycast hit {100 * share:.2f}% of the in-volume pixels")
    check(med < vs, f"{phase}: median |d depth| {1e3 * med:.4f} mm is not under one voxel")
    return share, med, ms


def device_kernels(torch, fn):
    """(device kernels launched, device ms, wall ms) of one call of fn under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    device_us = tool("profile_torch_frame")._device_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if device_us(e) > 0 and "CUDA" in str(getattr(e, "device_type", ""))]
    return sum(e.count for e in events), sum(device_us(e) for e in events) / 1e3, 1e3 * wall


def run_kinfu(torch, kernels, frames, poses, model, phase):
    """One KinFu run over the frames: per frame the seconds, the tracking
    flag and the pose error; per run the stage times, the peak memory, a
    profiled extra frame and a raycast's kernel count. Returns the launch
    counts of the hand-written kernels over the run (none are on this path)."""
    from sobfu_tpu_torch import kinfu as kinfu_mod
    from sobfu_tpu_torch import raycast
    from sobfu_tpu_torch.kinfu import KinFu, KinFuParams

    p = KinFuParams.default_params()
    p.track_against_model = model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kinfu = KinFu(p)  # no device: the card
    check(kinfu.tsdf().tsdf.device.type == "cuda", f"{phase}: KinFu(params) is not on cuda")
    clock = CallClock(torch)
    kinfu.icp_.estimate_transform = clock.wrap("icp", kinfu.icp_.estimate_transform)
    kinfu.volume_.integrate = clock.wrap("integrate", kinfu.volume_.integrate)
    saved = kinfu_mod.raycast_volume
    kinfu_mod.raycast_volume = clock.wrap("raycast", saved)
    kernels.reset_launch_counts()
    try:
        for k, (depth, pose) in enumerate(zip(frames[:KINFU_FRAMES], poses)):
            t0 = time.perf_counter()
            ok = kinfu(depth)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            dt_mm, dr_deg = pose_error(kinfu.get_camera_pose(), pose)
            log(phase, f"frame {k}: {dt:.4f} s, tracked {ok}, pose error {dt_mm:.4f} mm "
                f"{dr_deg:.4f} deg")
            check(ok, f"{phase}: frame {k} did not track")
    finally:
        kinfu_mod.raycast_volume = saved
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dt_mm, dr_deg = pose_error(kinfu.get_camera_pose(), poses[KINFU_FRAMES - 1])
    vs = min(kinfu.tsdf().voxel_sizes())
    log(phase, f"icp {clock.ms('icp')}, integrate {clock.ms('integrate')}, raycast "
        f"{clock.ms('raycast')}; peak memory {peak:.3f} GiB; final pose error "
        f"{dt_mm:.4f} mm {dr_deg:.4f} deg (bounds {1e3 * vs:.4f} mm, 0.5 deg)")
    check(dt_mm < 1e3 * vs and dr_deg < 0.5, f"{phase}: the final pose is off the truth")
    vol = kinfu.tsdf()
    check(vol.tsdf.device.type == "cuda" and bool(torch.isfinite(vol.tsdf).all())
          and bool(torch.isfinite(vol.weight).all()), f"{phase}: the volume is not finite on cuda")
    check(float(vol.weight.sum()) > 0, f"{phase}: nothing was integrated")
    check(sum(counts.values()) == 0, f"{phase}: a hand-written kernel launched: {counts}")
    _, _, ray_ms = check_raycast_against_depth(torch, raycast, kinfu, poses[KINFU_FRAMES - 1],
                                               frames[KINFU_FRAMES - 1], phase)
    n_kernels, dev_ms, wall_ms = device_kernels(torch, lambda: raycast.raycast_volume(
        vol, kinfu.get_camera_pose(), p.intr, p.rows, p.cols, p.raycast_step_factor))
    log(phase, f"one raycast at {p.cols}x{p.rows}, 512 steps: {n_kernels} device kernels, "
        f"{dev_ms:.4f} ms device, {wall_ms:.4f} ms wall (profiled)")
    n_kernels, dev_ms, wall_ms = device_kernels(torch, lambda: kinfu(frames[KINFU_FRAMES]))
    log(phase, f"profiled frame {KINFU_FRAMES}: {wall_ms:.4f} ms wall, {dev_ms:.4f} ms device, "
        f"busy {100 * dev_ms / wall_ms:.1f}%, {n_kernels} device kernels")
    return counts


def run_kinfu_phase(torch, kernels):
    """Phase 14: KinFu at KinFuParams.default_params() (640x480, 512^3)
    over KINFU_FRAMES frames of a static scene from a camera moving 5 mm in
    x and 0.2 degrees in yaw a frame, frame-to-frame and then frame-to-model.
    Returns the launch counts of both runs."""
    from sobfu_tpu_torch.kinfu import KinFuParams

    render = tool("render_rigid_scene")
    p = KinFuParams.default_params()
    poses = render.trajectory(KINFU_FRAMES + 1, KINFU_STEP_M, KINFU_YAW_DEG)
    frames = [render.render_depth(T, p.rows, p.cols, p.intr, spheres=KINFU_SPHERES,
                                  wall_z=KINFU_WALL_Z) for T in poses]
    log("kinfu", f"{p.cols}x{p.rows}, {p.volume_dims[0]}^3 of {p.volume_size[0]} m, ICP "
        f"{p.icp_iter_num}; {KINFU_FRAMES} frames, {1e3 * KINFU_STEP_M} mm and "
        f"{KINFU_YAW_DEG} deg a frame; TF32 matmuls {torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32, "kinfu: TF32 matmuls are on")
    return [run_kinfu(torch, kernels, frames, poses, False, "kinfu f2f"),
            run_kinfu(torch, kernels, frames, poses, True, "kinfu f2m")]


# ---------------------------------------------------------------------------
# phase 15: the analytic quality gates (tools/fidelity_torch.py) on the card
# ---------------------------------------------------------------------------

# (the tool's flags, the kernels that must launch, the scenes run again on
# the CPU): the JAX package's three CI lanes (.github/workflows/ci.yml) with
# their flags, then the full width: the tool's defaults, its production
# configuration at 64^3, and at 128^3 the fused dispatch, whose 64^3 coarse
# level runs E and whose inverse is the multigrid one
FIDELITY_ABC = ("gd_iteration", "warp", "inverse_fixed_point")
FIDELITY_SOLVES = "translation,expansion,rotation,bending"
FIDELITY_LANES = (
    ("--dim 32 --iters 384 --warp-window 4", FIDELITY_ABC + ("warp_fuse",), "all"),
    ("--dim 32 --iters 256 --warp-window 2 --production", FIDELITY_ABC + ("warp_fuse",), "all"),
    ("--dim 128 --iters 256 --warp-window 4 --scenarios translation,bending", FIDELITY_ABC,
     None),
    ("--dim 64", FIDELITY_ABC + ("warp_fuse",), FIDELITY_SOLVES),
    ("--dim 64 --production", FIDELITY_ABC + ("warp_fuse",), None),
    ("--dim 128 --iters 256 --warp-window 2 --production --fused "
     "--scenarios translation,bending", FIDELITY_ABC + ("gd_multi",), None),
)
# the report's keys held to the CPU's run of the same scenes, absolute
FIDELITY_KEYS = ("energy_ratio", "mesh_rmse_voxels", "inverse_consistency_max_vox",
                 "tracked_mean_dx_vox", "tracking_fraction")
FIDELITY_ATOL = 1e-4


@contextlib.contextmanager
def recording(torch, kernels, seen):
    """The with-block of a fidelity lane: the wrappers of B, warp_field3, C
    and D keep, cloned, the operands of their first call at each signature
    (the shapes, the window, the channels' rules, the steps, a start or the
    identity); each loop of A and E keeps its grid, taps, weights, momentum
    and window (and E's chunk) with its scene's tnp, canonical and live
    volumes. seen maps each signature to those operands. The calls go on to
    the kernels and are counted as before."""
    import inspect

    def keep(key, args):
        if key not in seen:
            seen[key] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    def wrapped(name):
        fn = getattr(kernels, name)
        sig = inspect.signature(fn)

        def call(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            a = tuple(bound.arguments.values())
            keep((name,) + tuple(tuple(v.shape) if torch.is_tensor(v)
                                 else tuple(v) if isinstance(v, list) else v for v in a), a)
            return fn(*args, **kw)

        return kernels, name, call

    class GdLoop(kernels.GdLoop):
        def __init__(self, kernel, psi, tnp, tg, live, taps, alpha, w_reg, momentum, K,
                     *rest, **kw):
            keep(("gd_iteration", tuple(psi.shape[-3:]), taps.shape[0], K, momentum),
                 (tnp[0], tg[0], live[0], taps, alpha, w_reg, momentum, K))
            super().__init__(kernel, psi, tnp, tg, live, taps, alpha, w_reg, momentum, K,
                             *rest, **kw)

    class GdMultiLoop(kernels.GdMultiLoop):
        def __init__(self, psi, tnp, tg, live, taps, alpha, w_reg, momentum, K, thresh,
                     max_iter, n_inner, *rest, **kw):
            keep(("gd_multi", tuple(psi.shape[1:]), taps.shape[0], K, momentum, n_inner),
                 (tnp, tg, live, taps, alpha, w_reg, momentum, K, n_inner))
            super().__init__(psi, tnp, tg, live, taps, alpha, w_reg, momentum, K, thresh,
                             max_iter, n_inner, *rest, **kw)

    with patched(*(wrapped(n) for n in ("warp", "warp_field3", "inverse_fixed_point",
                                         "warp_fuse")),
                 (kernels, "GdLoop", GdLoop), (kernels, "GdMultiLoop", GdMultiLoop)):
        yield


def replay(torch, kernels, fields, seen, lane):
    """Each signature a fidelity lane ran (:func:`recording`), its kernel
    against its plain version on the card. B and C on the lane's own operands
    within 1e-5 (B's floor channels bit for bit), warp_field3 bit for bit
    (and with three one-channel B launches), D bit for bit. A (with its
    energy) and E on the lane's tnp, canonical and live volumes, taps and
    weights, at a psi drawn around the identity (A: within
    K + 0.5 voxels, past the window; E: within 0.9 K; exact: 2.5) with a
    velocity of 0.1 where there is momentum: atol 1e-5 on the state, rtol
    1e-5 on the rows, as phase 3 holds them. Returns the largest
    difference."""
    rng = np.random.default_rng(7)
    worst = 0.0
    for key, a in seen.items():
        name = key[0]
        if name in ("gd_iteration", "gd_multi"):
            tnp, tg, live, taps, alpha, w_reg, mu, K = a[:8]
            dims = tuple(tg.shape)
            amp = 2.5 if K is None else K + 0.5 if name == "gd_iteration" else 0.9 * K
            psi = fields.identity_field(dims, device=tg.device) + torch.as_tensor(
                rng.uniform(-amp, amp, (3,) + dims).astype(np.float32), device=tg.device)
            vel = None if mu is None else torch.as_tensor(
                rng.normal(0.0, 0.1, (3,) + dims).astype(np.float32), device=tg.device)
            ops = (psi, tnp, vel, tg, live, taps, alpha, w_reg, mu, K) + tuple(a[8:])
            got = getattr(kernels, name)(*ops, with_energy=True)
            ref = getattr(kernels, name + "_plain")(*ops, with_energy=True)
            e = max(max_abs(g, r) for g, r in zip(got[:3], ref[:3]))
            rel = max(float(torch.max(torch.abs(g - r) / torch.abs(r).clamp_min(1e-30)))
                      for g, r in zip(got[3:], ref[3:]) if r is not None)
            ok, what = e <= 1e-5 and rel <= 1e-5, f"max|d| {e:.3e}, rel d rows {rel:.3e}"
        else:
            got = getattr(kernels, name)(*a)
            ref = getattr(kernels, name + "_plain")(*a)
            got, ref = (tuple(got), tuple(ref)) if name == "warp_fuse" else ((got,), (ref,))
            e = max(max_abs(g, r) for g, r in zip(got, ref))
            if name == "warp_fuse":
                ok = all(bitwise(g, r) for g, r in zip(got, ref))
            elif name == "warp":
                ok = e <= 1e-5 and all(bitwise(got[0][c], ref[0][c])
                                       for c, floor in enumerate(a[3]) if floor)
            elif name == "warp_field3":
                ok = bitwise(got[0], ref[0]) and bitwise(got[0], field3_by_channel(kernels, *a))
            else:
                ok = e <= 1e-5
            what = f"max|d| {e:.3e}"
        log("fidelity", f"{lane}: {name} {key[1:]} against its plain version: {what}")
        check(ok, f"fidelity: {lane}: {name} {key[1:]} disagrees with its plain version")
        worst = max(worst, e)
    return worst


def same_reports(card, cpu, lane):
    """The card's report against the CPU's run of the same scenes: equal
    iterations, FIDELITY_KEYS within FIDELITY_ATOL. Returns the largest
    difference."""
    mine = {r["scenario"]: r for r in card["results"]}
    worst = 0.0
    for want in cpu["results"]:
        got = mine[want["scenario"]]
        check(got.get("iters_run") == want.get("iters_run"),
              f"fidelity: {lane}: {want['scenario']} ran {got.get('iters_run')} iterations on "
              f"the card and {want.get('iters_run')} on the CPU")
        for k in FIDELITY_KEYS:
            if k in want:
                d = abs(got[k] - want[k])
                worst = max(worst, d)
                check(d <= FIDELITY_ATOL, f"fidelity: {lane}: {want['scenario']} {k} "
                      f"{got[k]!r} on the card, {want[k]!r} on the CPU")
    return worst


def run_fidelity_phase(torch, kernels, fields, cpu_dims=(32,)):
    """Phase 15: tools/fidelity_torch.py in this process on the card, lane by
    lane: its report, its seconds and each kernel's launches, beside the
    card's name and power limit. Every lane must pass the JAX package's
    budgets and launch the kernels named in FIDELITY_LANES. Then every
    kernel at every signature the lane ran is held to its plain version
    (:func:`replay`), and in the lanes of a grid in cpu_dims the scenes
    named in FIDELITY_LANES run again on the CPU (the plain torch path)
    and are held to the card's (:func:`same_reports`). The full script
    runs the CPU's half at 32^3 (about 80 s on an 8-core host), --fidelity
    at 64^3 too (about 140 s more). Returns the launch counts of each
    lane."""
    fid = tool("fidelity_torch")
    smi = nvidia_smi()
    runs = []
    for flags, expect, on_cpu in FIDELITY_LANES:
        args = fid.parse_args(flags.split() + ["--device", DEVICE])
        seen = {}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with recording(torch, kernels, seen):
            report = fid.run(args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(kernels.launch_counts)
        log("fidelity", f"{flags}: report {json.dumps(report)}")
        log("fidelity", f"{flags}: {secs:.4f} s, pass {report['pass']}, launches {counts} | {smi}")
        check(report["pass"], f"fidelity: {flags} missed a budget of tools/fidelity.py")
        for name in expect:
            check(counts[name] > 0, f"fidelity: {flags}: kernel {name} was never launched")
        runs.append(counts)
        e = replay(torch, kernels, fields, seen, flags)
        log("fidelity", f"{flags}: {len(seen)} kernel signatures held to their plain "
            f"versions, largest max|d| {e:.3e}")
        if on_cpu and args.dim in cpu_dims:
            cpu_flags = flags.split() + ["--device", "cpu", "--scenarios", on_cpu]
            t0 = time.perf_counter()
            ref = fid.run(fid.parse_args(cpu_flags))
            d = same_reports(report, ref, flags)
            log("fidelity", f"{flags}: the CPU's run of {on_cpu} ({time.perf_counter() - t0:.4f} "
                f"s): equal iterations, max|d| of {'/'.join(FIDELITY_KEYS)} {d:.3e} "
                f"(atol {FIDELITY_ATOL})")
    return runs


# ---------------------------------------------------------------------------
# phase 16: the logged compositive loop, the card against the CPU
# ---------------------------------------------------------------------------

LOGGED_DIM, LOGGED_FRAMES, LOGGED_STEP, LOGGED_RADIUS = 32, 4, 0.03, 0.2


# phase 17: the kernels bench_torch.py must launch
BENCH_KERNELS = ("gd_iteration", "gd_multi", "warp", "inverse_fixed_point", "warp_fuse",
                 "warp_field3")


def json_main(main, argv, phase):
    """main(argv) in this process with its standard output captured: (exit
    code, its last line parsed as JSON, seconds); the line is printed tagged
    with the phase."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    secs = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]
    log(phase, line)
    return rc, json.loads(line), secs


def leaves(prefix, value):
    """(dotted key, value) of every leaf of a JSON object."""
    if isinstance(value, dict):
        for k, v in value.items():
            yield from leaves(f"{prefix}.{k}" if prefix else k, v)
    elif isinstance(value, list):
        for i, v in enumerate(value):
            yield from leaves(f"{prefix}[{i}]", v)
    else:
        yield prefix, value


def run_bench_phase(torch, kernels):
    """Phase 17: bench_torch.py and the port's two bench tools on the card.
    Returns the launch counts of the three runs."""
    import bench_torch

    kernels.reset_launch_counts()
    rc, out, secs = json_main(bench_torch.main, ["--device", DEVICE], "bench")
    counts = dict(kernels.launch_counts)
    log("bench", f"bench_torch.py: exit {rc} in {secs:.2f} s (each cell's seconds and peak "
        f"memory on stderr); launch counts {counts}")
    check(rc == 0 and out["errors"] == {}, f"bench: cells failed: {out['errors']}")
    unset = [k for k, v in out.items() if v is None]
    check(not unset, f"bench: figures not set: {unset}")
    for key, v in leaves("", out):
        check(v is not None or key in out["null_reasons"], f"bench: {key} null without a reason")
        check(not isinstance(v, float) or math.isfinite(v), f"bench: {key} = {v}")
    for key in ("convergence_mode", "convergence_mode_256cubed", "convergence_mode_512cubed"):
        cell = out[key]
        check(cell["iters"] > 0 and math.isfinite(cell.get("e_ratio", 0.0)),
              f"bench: {key} {cell}")
    for name in BENCH_KERNELS:
        check(counts[name] > 0, f"bench: kernel {name} was never launched")

    kernels.reset_launch_counts()
    rc, stream, secs = json_main(stream_tool().main, ["--device", DEVICE], "bench")
    stream_counts = dict(kernels.launch_counts)
    log("bench", f"tools/bench_multiscene_stream_torch.py: exit {rc} in {secs:.2f} s; launch "
        f"counts {stream_counts}")
    check(rc == 0 and stream["tracking_ok"] is True, "bench: the multiscene stream does not track")
    check(stream_counts["gd_iteration_scenes"] > 0, "bench: A over scenes was never launched")

    kernels.reset_launch_counts()
    rc, inv, secs = json_main(tool("check_inverse_multigrid_torch").main,
                              ["--device", DEVICE], "bench")
    inv_counts = dict(kernels.launch_counts)
    log("bench", f"tools/check_inverse_multigrid_torch.py: exit {rc} in {secs:.2f} s; launch "
        f"counts {inv_counts}")
    figures = [v for row in inv["rows"].values() for v in row.values()]
    check(rc == 0 and len(figures) == 16 and all(math.isfinite(v) for v in figures),
          f"bench: the inverse tool's figures {inv['rows']}")
    for name in ("inverse_fixed_point", "warp_field3"):
        check(inv_counts[name] > 0, f"bench: the inverse tool never launched {name}")
    return [counts, stream_counts, inv_counts]


def run_logged_phase(torch, kernels, ini):
    """Phase 16: the compositive frame loop with the inverse warps on (the
    logged loop, need_inv_warps), which runs two paths nothing else runs on
    the card: the incremental inverse (INCREMENTAL_INV=1: C on the increment
    in the window, its displacement sampled exactly at psi_inv0, exact
    anchoring steps) and the exact compositive tails (phi_global o psi_inv,
    B without a window). compositive_params at 32^3 (1 voxel of 31 mm, so
    no fused dispatch: the exact composition), LOGGED_FRAMES frames of a 0.2
    m sphere moving 30 mm a frame, on the card and on the CPU from the same
    depth. psi and psi_inv within 8 ulps of the largest coordinate; the
    card's tails against B's plain version at the card's psi_inv (atol 1e-5,
    the floor-warped weight bit for bit). Returns the card's launch counts."""
    from sobfu_tpu_torch.pipeline import SobFusion

    params = compositive_params(ini)
    params.volume_dims = (LOGGED_DIM,) * 3
    params.incremental_inverse = True
    frames = render_frames(params, LOGGED_FRAMES, LOGGED_STEP, LOGGED_RADIUS)
    state = {}
    counts = None
    for dev in (DEVICE, "cpu"):
        fusion = SobFusion(params, device=dev)
        check(fusion.need_inv_warps, "logged: the inverse warps are off")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for i, depth in enumerate(frames):
            if i == len(frames) - 1:  # the last solve's tails warp these
                tg, wg = fusion.phi_global.tsdf.clone(), fusion.phi_global.weight.clone()
            fusion(depth)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        s = fusion.solver
        if counts is None:
            counts = dict(kernels.launch_counts)
            check(s.mode == "compositive" and s.takes_psi_inv0 and not s.fused,
                  "logged: not the exact compositive loop with the incremental inverse")
        log("logged", f"{dev}: {LOGGED_FRAMES} frames in {secs:.4f} s, last solve "
            f"{fusion.last_solve.iters} iterations; launches {dict(kernels.launch_counts)}")
        state[dev] = {
            "psi": fusion.psi.data, "psi_inv": fusion.psi_inv.data,
            "tails_tsdf": fusion.phi_global_psi_inv.tsdf,
            "tails_weight": fusion.phi_global_psi_inv.weight,
            "tg": tg, "wg": wg,
        }
    card, cpu = state[DEVICE], {k: v.to(DEVICE) for k, v in state["cpu"].items()}
    ulps = 8 * float(np.spacing(np.float32(LOGGED_DIM - 1)))
    for key in ("psi", "psi_inv"):
        e = max_abs(card[key], cpu[key])
        log("logged", f"{key}: card against CPU max|d| = {e:.3e} (8 ulps: {ulps:.3e})")
        check(e <= ulps, f"logged: {key} on the card disagrees with the CPU")
    # the last solve's tails: canonical tsdf and weight before its fuse,
    # warped exactly at its psi_inv; B's plain version on the card's inputs
    want = kernels.warp_plain(torch.stack([card["tg"], card["wg"]]), card["psi_inv"], None,
                              (False, True))
    e_t = max_abs(card["tails_tsdf"], want[0])
    same_w = bitwise(card["tails_weight"], want[1])
    log("logged", f"tails against B's plain version: tsdf max|d| = {e_t:.3e}, weight bit for "
        f"bit {same_w}; card against CPU: tsdf max|d| = "
        f"{max_abs(card['tails_tsdf'], cpu['tails_tsdf']):.3e}, weight differs at "
        f"{int((card['tails_weight'] != cpu['tails_weight']).sum())} voxels")
    check(e_t <= 1e-5 and same_w, "logged: the exact tails disagree with B's plain version")
    for name in ("inverse_fixed_point", "warp_field3", "warp", "gd_iteration"):
        check(counts[name] > 0, f"logged: kernel {name} was never launched")
    return counts


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of sobfu_tpu_torch on one CUDA card")
    ap.add_argument("--probe", metavar="DIR",
                    help="run the drift witness and the compositive profiles instead")
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the build, the kernel checks and the goldens")
    ap.add_argument("--sharded", action="store_true",
                    help="run the build and phase 13 (sharded) alone")
    ap.add_argument("--kinfu", action="store_true",
                    help="run the build and phase 14 (kinfu) alone")
    ap.add_argument("--fidelity", action="store_true",
                    help="run the build and phases 15 (fidelity) and 16 (logged) alone")
    ap.add_argument("--bench", action="store_true",
                    help="run the build and phase 17 (bench_torch.py and its tools) alone")
    args = ap.parse_args(argv)

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

    ini = os.path.join(ROOT, "params", "params_umbrella.ini")
    if args.probe:
        probe(torch, kernels, ini, args.probe)
        return 0
    if args.sharded:
        run_sharded_phase(torch, kernels, solver)
        return 0
    if args.kinfu:
        run_kinfu_phase(torch, kernels)
        return 0
    if args.fidelity:
        run_fidelity_phase(torch, kernels, fields, cpu_dims=(32, 64))
        run_logged_phase(torch, kernels, ini)
        return 0
    if args.bench:
        run_bench_phase(torch, kernels)
        return 0
    results = check_kernels(torch, kernels, fields, solver)
    front = check_frontend(torch, load_params(ini))
    check_goldens(torch, fields, solver)
    if args.kernels:
        return 0

    path_kernels = ("gd_iteration", "warp", "inverse_fixed_point", "warp_fuse")
    pyramid_kernels = path_kernels + ("gd_multi",)
    params = load_params(ini)
    params.warp_window = 2
    runs = [run_frames(torch, kernels, params, 4, "main", path_kernels)[0],
            run_frames(torch, kernels, load_params(ini), 2, "shipped", path_kernels)[0]]

    production_params = tool("profile_torch_frame").production_params
    runs.append(run_pyramid(torch, kernels, production_params(ini, DIM, 2), 4, "pyramid",
                            pyramid_kernels))
    runs.append(run_pyramid(torch, kernels, production_params(ini, 2 * DIM, 3), 2,
                            "pyramid256", pyramid_kernels))

    real = {}
    runs.append(run_compositive(torch, kernels, compositive_params(ini), 6, 0.009,
                                ("warp", "gd_multi", "gd_iteration", "warp_field3"), real))
    results["warp_field3"]["also"].update(field3_real_rows(torch, kernels, fields, real))

    params = production_params(ini, DIM, 2)
    params.fine_window = 1
    runs.append(run_pyramid(torch, kernels, params, 4, "fine_window",
                            ("gd_multi", "warp", "gd_iteration", "compose_weight",
                             "inverse_fixed_point")))
    runs.extend(run_multiscene_phase(torch, kernels))
    runs.extend(run_cli_phase(torch, kernels, ini))
    results["gd_iteration_slab"], sharded = run_sharded_phase(torch, kernels, solver)
    runs.extend(sharded)
    runs.extend(run_kinfu_phase(torch, kernels))
    runs.extend(run_fidelity_phase(torch, kernels, fields))
    runs.append(run_logged_phase(torch, kernels, ini))
    runs.extend(run_bench_phase(torch, kernels))
    torch.cuda.synchronize()
    all_kernels = tuple(kernels.launch_counts)
    launches = {name: sum(c[name] for c in runs) for name in all_kernels}

    from sobfu_tpu_torch.ops import frontend

    print(frontend_report(frontend, front, {
        name: sum(c.get(name, 0) for c in runs) for name in frontend.launch_counts}))
    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": kernels.KERNELS[name][0],
            "replaces": kernels.KERNELS[name][1],
            "launches": launches[name],
            **results[name],
        }
        for name in all_kernels
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
