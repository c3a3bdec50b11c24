"""Kernels B (with warp_field3), A (and its slab form), E and C of the PyTorch
port timed on one CUDA card, for comparing two trees inside one call.

    python tools/bench_torch_kernels.py [--root DIR] [--label NAME] [--out FILE]
                                        [--only B,F3,A,slab,E,C] [--slab-cards N]

imports ``sobfu_tpu_torch`` from DIR (default: this checkout), builds its
kernels and times, at the main path's shapes and with chip_smoke.py's two
yardsticks (``cuda_ms``: one event pair around a run of 20 calls, median of
7 runs; ``device_ms``: torch.profiler's device time per call):

  B   the exact warp of one 128^3 volume at psi_x (+-3.5 voxels) and at
      psi_w (+-1.8), each in turns with torch.nn.functional.grid_sample on
      the same inputs (B, library, library, B); the K=2 warp at psi_w; the
      mixed warp (C = 2: a trilinear and a floor channel, K=2, the tails'
      warp); the exact warp at a smooth field of 3.5 voxels, the K=2 and
      the mixed warp at one of 1.95 (chip_smoke.smooth_displacement: sines
      of wavelength 32 voxels)
  F3  warp_field3 (B on three channels) exact at psi_x and at the smooth
      field of 3.5 voxels, K=2 at psi_w, each in turns with grid_sample on
      the same three channels (B, library, library, B)
  A   one iteration at 128^3, K=2, 7 taps, without and with momentum 0.95;
      at 64^3, K=1, momentum 0.95; over S = 4 scenes of 128^3, K=2,
      momentum 0.95; and, where the tree has kernels.GdLoop, the same through
      chunks of 16 iterations per call (per iteration)
  A's slab form  where the tree has kernels.GdSlabLoop, an iteration of it
      at 128^3 in 4 slabs of the card, K=2, momentum 0.95, through chunks
      of 16 (the loop's own layout: one launch a slab and iteration in the
      first form, one card group in the redesign); with --slab-cards N the
      4 slabs lie on cards 0..N-1, 4/N consecutive slabs each (N = 4: one
      slab a card, make_mesh's default layout), and the case adds
      ``wall_ms``, host milliseconds an iteration over 20 calls, median of
      7 (its device_ms then sums the cards')
  E   one launch of 16 iterations at 64^3, K=1, 7 taps, momentum 0.95 (the
      pyramid's coarse level); where the tree has kernels.GdMultiLoop, the
      same through the loop (8 launches per call, per launch) and one
      launch at each segment length GD_MULTI_MIN_LZ of 2, 4 and 8 planes
  C   3 warm steps at 128^3, K=2 (the slice); 3 warm steps at 64^3, K=1
      (the pyramid's multigrid coarse inverse); 48 exact steps from the
      identity at 128^3 (the shipped ini)

Only wrappers that every tree of the port has are called, so the same
script measures a tree from before a kernel's redesign and one after it:

    mkdir -p _checkout/parent && git archive <commit> | tar -x -C _checkout/parent
    for r in _checkout/parent . . _checkout/parent; do
        python tools/bench_torch_kernels.py --root $r --label $r; done

--only times only the named parts (default: all). Prints one JSON object
per run (the card's name and power limit in it); --out appends it to FILE.
Needs a CUDA card (N of them with --slab-cards N); fails without one.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="the tree whose sobfu_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None, help="append the JSON line to this file")
    ap.add_argument("--only", default="B,F3,A,slab,E,C", help="the parts to time")
    ap.add_argument("--slab-cards", type=int, default=1, choices=(1, 2, 4),
                    help="the cards the slab loop's 4 slabs lie on")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.slab_cards:
        print(f"bench_torch_kernels: needs {args.slab_cards} CUDA card(s)", file=sys.stderr)
        return 2
    parts = set(args.only.split(","))
    known = {"B", "F3", "A", "slab", "E", "C"}
    if parts - known:
        ap.error(f"--only: unknown parts {sorted(parts - known)}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from sobfu_tpu_torch import fields, solver
    from sobfu_tpu_torch.ops import _build, kernels
    from sobfu_tpu_torch.tsdf import init_sphere

    check = os.path.abspath(os.path.dirname(os.path.dirname(kernels.__file__)))
    if os.path.dirname(check) != root:
        raise RuntimeError(f"sobfu_tpu_torch came from {check}, not from {root}")
    _build.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    def both(fn):
        return {"ms": smoke.cuda_ms(fn), "device_ms": smoke.device_ms(fn)}

    def scene(n):
        dims, vs = (n, n, n), 1.0 / n
        tg, _ = init_sphere(dims, (vs,) * 3, (0.5, 0.5, 0.5), 0.2, 8 * vs, 3 * vs, device=dev)
        live, _ = init_sphere(dims, (vs,) * 3, (0.49, 0.5, 0.5), 0.2, 8 * vs, 3 * vs, device=dev)
        ident = fields.identity_field(dims, device=dev)
        return dims, tg, live, ident

    dims, tg, live, ident = scene(128)
    psi_w = ident + t(rng.uniform(-1.8, 1.8, (3,) + dims))
    psi_x = ident + t(rng.uniform(-3.5, 3.5, (3,) + dims))
    tnp = live + t(rng.normal(0.0, 0.05, dims))
    vel = t(rng.normal(0.0, 0.1, (3,) + dims))
    wgc = t(rng.integers(0, 4, dims).astype(np.float32))
    taps = torch.as_tensor(solver.sobolev_filter_1d(7, 0.1), device=dev)
    vol1 = tg[None].contiguous()
    vol2 = torch.stack([tg, wgc]).contiguous()
    field = ident + t(rng.uniform(-2.0, 2.0, (3,) + dims))
    out = {"label": args.label or root, "card": smoke.nvidia_smi(),
           "torch": torch.__version__}

    smooth_x = ident + t(smoke.smooth_displacement(dims, 3.5, 1))
    smooth_w = ident + t(smoke.smooth_displacement(dims, 1.95, 2))
    for name, psi in (("psi_x", psi_x), ("psi_w", psi_w)) if "B" in parts else ():
        lib, err = smoke.library_warp(torch, vol1, psi, kernels.warp(vol1, psi, None, (False,)))
        if err > 1e-4:
            raise RuntimeError(f"grid_sample differs from B at {name}: {err}")

        def b_call(psi=psi):
            return kernels.warp(vol1, psi, None, (False,))

        turns = [both(b_call), both(lib), both(lib), both(b_call)]
        out[f"warp_exact_{name}"] = [turns[0], turns[3]]
        out[f"grid_sample_{name}"] = [turns[1], turns[2]]
    if "B" in parts:
        out["warp_K2_psi_w"] = both(lambda: kernels.warp(vol1, psi_w, 2, (False,)))
        out["warp_mixed_K2_psi_w"] = both(lambda: kernels.warp(vol2, psi_w, 2, (False, True)))
        out["warp_exact_smooth"] = both(lambda: kernels.warp(vol1, smooth_x, None, (False,)))
        out["warp_K2_smooth"] = both(lambda: kernels.warp(vol1, smooth_w, 2, (False,)))
        out["warp_mixed_K2_smooth"] = both(lambda: kernels.warp(vol2, smooth_w, 2, (False, True)))
    for name, K, psi in ((("exact_psi_x", None, psi_x), ("exact_smooth", None, smooth_x),
                          ("K2_psi_w", 2, psi_w)) if "F3" in parts else ()):
        lib, err = smoke.library_warp(torch, field, psi, kernels.warp_field3(field, psi, K))
        if err > 1e-4:
            raise RuntimeError(f"grid_sample differs from warp_field3 at {name}: {err}")

        def f3_call(psi=psi, K=K):
            return kernels.warp_field3(field, psi, K)

        turns = [both(f3_call), both(lib), both(lib), both(f3_call)]
        out[f"warp_field3_{name}"] = [turns[0], turns[3]]
        out[f"grid_sample_field3_{name}"] = [turns[1], turns[2]]

    for mu in (None, 0.95) if "A" in parts else ():
        a = (psi_w, tnp, vel, tg, live, taps, 0.05, 0.2, mu, 2)
        out[f"gd_iteration_128_K2_momentum_{mu}"] = both(lambda a=a: kernels.gd_iteration(*a))
    S = 4
    if "A" in parts:
        a = (psi_w, tnp, vel, tg, live, taps, 0.05, 0.2, 0.95, 2)
        out["gd_iteration_128_K2_momentum_0.95_energy"] = both(
            lambda: kernels.gd_iteration(*a, with_energy=True))
        b = (torch.stack([psi_w] * S), torch.stack([tnp] * S), torch.stack([vel] * S),
             torch.stack([tg] * S), torch.stack([live] * S))
        on = torch.ones(S, dtype=torch.bool, device=dev)
        out["gd_iteration_scenes_4x128_K2_momentum_0.95"] = both(
            lambda: kernels.gd_iteration_scenes(*b, taps, 0.05, 0.2, 0.95, 2, on))
        del b

    tnp128, tg128, live128 = tnp, tg, live
    dims, tg, live, ident = scene(64)
    psi = ident + t(rng.uniform(-0.9, 0.9, (3,) + dims))
    tnp = live + t(rng.normal(0.0, 0.05, dims))
    vel = t(rng.normal(0.0, 0.1, (3,) + dims))
    if "A" in parts:
        out["gd_iteration_64_K1_momentum_0.95"] = both(
            lambda: kernels.gd_iteration(psi, tnp, vel, tg, live, taps, 0.05, 0.2, 0.95, 1))

    if "A" in parts and hasattr(kernels, "GdLoop"):  # a tree with the chunked loop: A as the solves run it
        b = (torch.stack([psi_w] * S), torch.stack([tnp128] * S), torch.stack([tg128] * S),
             torch.stack([live128] * S))
        out["gd_loop_128_K2_momentum_None"] = smoke.timed_chunks(
            kernels, "gd_iteration", *(a[:1] for a in b), taps, 0.05, 0.2, None, 2)
        out["gd_loop_128_K2_momentum_0.95"] = smoke.timed_chunks(
            kernels, "gd_iteration", *(a[:1] for a in b), taps, 0.05, 0.2, 0.95, 2)
        out["gd_loop_scenes_4x128_K2_momentum_0.95"] = smoke.timed_chunks(
            kernels, "gd_iteration_scenes", *b, taps, 0.05, 0.2, 0.95, 2)
        del b
        out["gd_loop_64_K1_momentum_0.95"] = smoke.timed_chunks(
            kernels, "gd_iteration", psi[None], tnp[None], tg[None], live[None], taps, 0.05, 0.2,
            0.95, 1)
    if "slab" in parts and hasattr(kernels, "GdSlabLoop"):  # as the z-sharded solve runs it
        from sobfu_tpu_torch.parallel import zshard

        N = args.slab_cards
        devs = [torch.device("cuda", j * N // 4) for j in range(4)] if N > 1 else [dev] * 4
        state = [zshard._split(x[None], devs) for x in (psi_w, tnp128)]
        pad = [zshard._halo_exchange_z(zshard._split(x[None], devs), zshard.H)
               for x in (tg128, live128)]
        loop = kernels.GdSlabLoop(*state, *pad, taps, 0.05, 0.2, 0.95, 2, -1.0, 128)
        n, on = kernels.GD_CHUNK, np.ones(1, bool)
        key = "gd_slab_loop_128_4slabs" + (f"_{N}cards" if N > 1 else "") + "_K2_momentum_0.95"
        out[key] = {"ms": smoke.cuda_ms(lambda: loop.run(n, on), reps=4) / n,
                    "device_ms": smoke.device_ms(lambda: loop.run(n, on), reps=4) / n}
        if N > 1:  # the device time above sums the cards'
            walls = []
            for _ in range(7):
                t0 = time.perf_counter()
                for _ in range(20):
                    loop.run(n, on)
                walls.append((time.perf_counter() - t0) * 1e3 / (20 * n))
            out[key]["wall_ms"] = float(np.median(walls))
        del loop, state, pad

    # E at the coarse level's shapes (chip_smoke.py check_gd_multi's case)
    psi = ident + t(rng.uniform(-0.9, 0.9, (3,) + dims))
    e_args = (psi, tnp, vel, tg, live, taps, 0.05, 0.2, 0.95, 1, 16)
    if "E" in parts:
        out["gd_multi_64_K1_momentum_0.95"] = both(lambda: kernels.gd_multi(*e_args))
    if "E" in parts and hasattr(kernels, "GdMultiLoop"):
        loop = kernels.GdMultiLoop(psi, tnp, tg, live, taps, 0.05, 0.2, 0.95, 1, -1.0, 1 << 30,
                                   16)
        m = kernels.GD_MULTI_LAUNCHES
        out["gd_multi_loop_64_K1_momentum_0.95"] = {
            "ms": smoke.cuda_ms(lambda: loop.run(m), reps=4) / m,
            "device_ms": smoke.device_ms(lambda: loop.run(m), reps=4) / m}
        default = kernels.GD_MULTI_MIN_LZ
        for lz in (2, 4, 8):
            kernels.GD_MULTI_MIN_LZ = lz
            plan = kernels.gd_multi_plan(dims, 7, torch.cuda.get_device_properties(0)
                                         .multi_processor_count)
            out[f"gd_multi_64_K1_momentum_0.95_LZ{plan['LZ']}"] = dict(
                both(lambda: kernels.gd_multi(*e_args)), blocks=plan["blocks"])
        kernels.GD_MULTI_MIN_LZ = default

    # C: the slice's warm window inverse, the multigrid coarse one, the shipped exact one
    if "C" in parts:
        warm = kernels.inverse_fixed_point_plain(psi, 2, 1)
        out["inverse_64_K1_3_warm"] = both(lambda: kernels.inverse_fixed_point(psi, 3, 1, warm))
        dims, tg, live, ident = scene(128)
        psi = ident + t(rng.uniform(-0.9, 0.9, (3,) + dims))
        warm = kernels.inverse_fixed_point_plain(psi, 2, 2)
        out["inverse_128_K2_3_warm"] = both(lambda: kernels.inverse_fixed_point(psi, 3, 2, warm))
        out["inverse_128_exact_48"] = both(lambda: kernels.inverse_fixed_point(psi, 48, None))

    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
