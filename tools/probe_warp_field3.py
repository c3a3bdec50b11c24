"""warp_field3's design variants (tools/probe_warp_field3.cu) timed on one CUDA
card beside the port's kernel, three one-channel B launches and
torch.nn.functional.grid_sample, with the compiler's account of each.

    python tools/probe_warp_field3.py [--out FILE] [--dim N] [--variants 0,2,5]

Builds the variants with the package's nvcc flags (``-Xptxas -v``: registers,
spills and shared memory per kernel) and the package's library, counts the
LDG instructions and all instructions of each kernel in ``cuobjdump -sass``,
then at 128^3 (field = id + U(-2, 2) voxels) and for each case

  exact at psi_x   id + U(-3.5, 3.5) voxels, drawn independently a voxel
  exact at smooth  id + chip_smoke.smooth_displacement(3.5): sines of
                   wavelength 32 voxels
  K=2 at psi_w     id + U(-1.8, 1.8)
  K=2 at smooth    id + chip_smoke.smooth_displacement(1.95)

holds every variant bit for bit to warp_field3_plain (also on (12, 16, 20),
17^3 and positions up to 6 voxels outside the grid) and times, in turns
(each in order, then in reverse), every variant, kernels.warp_field3,
kernels.warp on each channel and grid_sample: chip_smoke.py's ``ms`` (one
event pair around 20 calls, median of 7) and ``device_ms`` (torch.profiler's
device time per call). Prints one JSON object, the card's name and power
limit in it; --out writes it to FILE too. Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "tools", "probe_warp_field3.cu")
NAMES = ("parent", "parent_per2", "once", "once_seq", "tile", "f4", "f4_tile", "f4_per2",
         "staged", "staged_l", "tile_32x8x1", "tile_32x2x4", "tile_16x4x4", "tile_16x8x2",
         "tile_8x8x4", "tile_8x4x8", "tile_16x2x8", "tile_z2", "tile_z4", "tile_16x4x4_z2",
         "tile_maxl1", "tile_16x4x4_maxl1")


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(_build):
    """The variants' library (built anew) and ptxas's lines for it."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libprobe_field3_{os.getpid()}.so"
    log = _build._run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                       "-I", str(_build.SRC_DIR), "-shared", "-o", str(lib), SRC])
    return lib, log


def demangle(names):
    cxxfilt = shutil.which("c++filt")
    if cxxfilt is None:
        return dict(zip(names, names))
    out = subprocess.run([cxxfilt], input="\n".join(names), capture_output=True, text=True)
    return dict(zip(names, out.stdout.splitlines()))


def sass_counts(lib, pattern):
    """{kernel: {"LDG": n, "LDS": n, "instructions": n}} of the kernels in
    lib whose demangled name matches pattern, from cuobjdump -sass."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    blocks = re.split(r"\n\s*Function : (\S+)\n", text)
    names = blocks[1::2]
    pretty = demangle(names)
    counts = {}
    for name, body in zip(names, blocks[2::2]):
        if not re.search(pattern, pretty[name]):
            continue
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
        counts[pretty[name]] = {"LDG": sum(i.startswith("LDG") for i in ins),
                                "LDS": sum(i.startswith("LDS") for i in ins),
                                "instructions": len(ins)}
    return counts


def ptxas_lines(log, pattern):
    """ptxas's 'Used N registers ...' line of each kernel matching pattern."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or re.search(
            r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
        elif current and ("registers" in line or "spill" in line):
            out.setdefault(current, []).append(line.strip().split("ptxas info    : ")[-1])
    pretty = demangle(list(out))
    return {pretty[k]: v for k, v in out.items() if re.search(pattern, pretty[k])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--variants", default=",".join(str(i) for i in range(len(NAMES))))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_warp_field3: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sobfu_tpu_torch import fields
    from sobfu_tpu_torch.ops import _build, kernels

    smoke = chip_smoke()
    variants = [int(v) for v in args.variants.split(",")]
    prod_lib, prod_log = _build.build(verbose=True)
    _build.library()
    lib_path, log = build(_build)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.probe_field3
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, P, P, I, I, I, I, P]
    fn.restype = I
    report = {"card": smoke.nvidia_smi(), "torch": torch.__version__,
              "ptxas": {**ptxas_lines(prod_log, r"warpn_kernel"),
                        **ptxas_lines(log, r"probe::")},
              "sass": {**sass_counts(prod_lib, r"warpn_kernel"),
                       **sass_counts(lib_path, r"probe::")}}
    dev = torch.device("cuda")

    def run(v, field, pos, K):
        Z, Y, X = field.shape[1:]
        out = torch.empty_like(field)
        scratch = torch.empty(Z * Y * X * 4, device=dev) if 5 <= v <= 7 else None
        rc = fn(v, field.data_ptr(), pos.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), Z, Y, X,
                -1 if K is None else K, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"variant {NAMES[v]}: CUDA error {rc}")
        return out

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    # every variant bit for bit with the plain version on small grids
    rng = np.random.default_rng(11)
    checked, wrong = 0, {}
    for dims in ((12, 16, 20), (17, 17, 17)):
        ident = fields.identity_field(dims, device=dev)
        field = ident + t(rng.uniform(-2.0, 2.0, (3,) + dims))
        for amp in (1.95, 3.5, 6.0):
            pos = ident + t(rng.uniform(-amp, amp, (3,) + dims))
            for K in (None, 1, 2, 4):
                want = kernels.warp_field3_plain(field, pos, K)
                for v in variants:
                    got = run(v, field, pos, K)
                    if not torch.equal(got, want):
                        wrong.setdefault(NAMES[v], []).append(
                            [dims, amp, K, float((got - want).abs().max())])
                    checked += 1
    report["bitwise_small"] = {"checked": checked, "wrong": wrong}
    print(f"small grids: {checked} checks, wrong {wrong}", flush=True)
    variants = [v for v in variants if NAMES[v] not in wrong]

    dims = (args.dim,) * 3
    rng = np.random.default_rng(0)
    ident = fields.identity_field(dims, device=dev)
    field = ident + t(rng.uniform(-2.0, 2.0, (3,) + dims))
    cases = (("exact_psi_x", None, ident + t(rng.uniform(-3.5, 3.5, (3,) + dims))),
             ("exact_smooth", None, ident + t(smoke.smooth_displacement(dims, 3.5, 1))),
             ("K2_psi_w", 2, ident + t(rng.uniform(-1.8, 1.8, (3,) + dims))),
             ("K2_smooth", 2, ident + t(smoke.smooth_displacement(dims, 1.95, 2))))
    for label, K, pos in cases:
        want = kernels.warp_field3_plain(field, pos, K)
        calls = {}
        for v in variants:
            if torch.equal(run(v, field, pos, K), want):
                calls[NAMES[v]] = lambda v=v: run(v, field, pos, K)
            else:
                wrong.setdefault(NAMES[v], []).append(label)
        if not torch.equal(kernels.warp_field3(field, pos, K), want):
            raise RuntimeError(f"kernels.warp_field3 differs from the plain version at {label}")
        calls["warp_field3"] = lambda: kernels.warp_field3(field, pos, K)
        chans = [field[c:c + 1] for c in range(3)]
        calls["B_x3"] = lambda: [kernels.warp(ch, pos, K, (False,)) for ch in chans]
        lib_call, lib_err = smoke.library_warp(torch, field, pos, want)
        calls["grid_sample"] = lib_call
        order = list(calls)
        times = {k: [] for k in order}
        for name in order + order[::-1]:
            times[name].append(smoke.timed(calls[name]))
        report[label] = {"grid_sample_max_abs_diff": lib_err, "times": times}
        best = {k: min(x["device_ms"] for x in v) for k, v in times.items()}
        print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in best.items()), flush=True)
    # B's forms: the parent's rows against the package's tiles at kPer 1, 2
    fb = lib.probe_warp
    fb.argtypes = [I, P, I, P, P, I, I, I, I, ctypes.c_uint, P]
    fb.restype = I

    def run_b(v, vol, pos, K, floor):
        C, Z, Y, X = vol.shape
        out = torch.empty_like(vol)
        rc = fb(v, vol.data_ptr(), C, pos.data_ptr(), out.data_ptr(), Z, Y, X,
                -1 if K is None else K, sum(1 << c for c in range(C) if floor[c]),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"B variant {v}: CUDA error {rc}")
        return out

    b_names = ("rows_parent", "package", "tiles_getter", "tiles_offsets", "rows_offsets")
    forms = {"B_C1": lambda f: (f[:1].contiguous(), (False,)),
             "B_C2_mixed": lambda f: (torch.stack([f[0], (f[1] % 4.0).floor()]), (False, True)),
             "B_C3": lambda f: (f, (False,) * 3)}
    rng = np.random.default_rng(12)
    for dims in ((12, 16, 20), (17, 17, 17)):
        small = fields.identity_field(dims, device=dev)
        f = small + t(rng.uniform(-2.0, 2.0, (3,) + dims))
        for amp in (1.95, 6.0):
            pos = small + t(rng.uniform(-amp, amp, (3,) + dims))
            for K in (None, 2):
                for form, make in forms.items():
                    vol, floor = make(f)
                    want = kernels.warp_plain(vol, pos, K, floor)
                    for v in range(len(b_names)):
                        if not torch.equal(run_b(v, vol, pos, K, floor), want):
                            wrong.setdefault(f"{form}_{b_names[v]}", []).append([dims, amp, K])
    print(f"B's forms on small grids: wrong {wrong}", flush=True)
    for form, make in forms.items():
        vol, floor = make(field)
        for label, K, pos in cases:
            want = kernels.warp_plain(vol, pos, K, floor)
            calls = {}
            for v in range(len(b_names)):
                if torch.equal(run_b(v, vol, pos, K, floor), want):
                    calls[b_names[v]] = lambda v=v: run_b(v, vol, pos, K, floor)
                else:
                    wrong.setdefault(f"{form}_{b_names[v]}", []).append(label)
            order = list(calls)
            times = {k: [] for k in order}
            for name in order + order[::-1]:
                times[name].append(smoke.timed(calls[name]))
            report[f"{form}_{label}"] = {"times": times}
            best = {k: min(x["device_ms"] for x in v) for k, v in times.items()}
            print(f"{form} {label}: " + ", ".join(f"{k} {v:.4f}" for k, v in best.items()),
                  flush=True)
    report["wrong"] = wrong
    text = json.dumps(report)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
