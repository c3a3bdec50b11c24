"""Accuracy of the multigrid warm inverse against the cold 48-step inverse
and the warm 3-step one, at the production scene: the counterpart of
tools/check_inverse_multigrid.py (which runs the JAX package) on the
PyTorch port.

    python tools/check_inverse_multigrid_torch.py [dim] [--device cuda|cpu]

Both metrics are in voxels at the fine resolution:
  max |q - q_cold48|     the field's error against the exact fixed point
  max |psi(q(v)) - v|    the composition residual (what fusion feels)

psi is a real production solve (the pyramid with a K=1 compositive fine
level) of the sphere pair the convergence cells use; the warm starts are
that solve's own inverse (favourable) and the inverse of a previous frame
with half the shift (what the steady loop feeds). The inverses run on
kernel C (``kernels.inverse_fixed_point``) directly and through
``pyramid.estimate_inverse_multigrid``; the residual composes with
``kernels.warp_field3`` at K=2, so where psi's displacement passes 2
voxels the residual is at least the excess, whatever the inverse. Prints
the JAX tool's rows, then one JSON line: {"dim", "psi_max_disp_vox" (the
largest |psi - id| component), "rows": {row: {"max_dq_vox",
"resid_vox"}}, "platform"}.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def run(dim: int = 256, device="cuda") -> dict:
    """Every row's two metrics at dim^3; returns the JSON's dict."""
    from sobfu_tpu_torch import core, fields, pyramid, solver
    from sobfu_tpu_torch.ops import kernels
    from sobfu_tpu_torch.tsdf import init_sphere

    dev = core.resolve_device(device)
    vs = 1.0 / dim
    dims = (dim,) * 3
    trunc, eta = 8.0 * vs, 3.0 * vs
    tg, wg = init_sphere(dims, (vs,) * 3, (0.5, 0.5, 0.5), 0.20, trunc, eta, device=dev)
    tn, wn = init_sphere(dims, (vs,) * 3, (0.5 - 1.3 * vs, 0.5, 0.5), 0.205, trunc, eta,
                         device=dev)
    prev_tn, _ = init_sphere(dims, (vs,) * 3, (0.5 - 0.6 * vs, 0.5, 0.5), 0.202, trunc, eta,
                             device=dev)
    taps = solver.sobolev_filter_1d(7, 0.1)
    ident = fields.identity_field(dims, device=dev)

    def production_solve(live):
        return solver.estimate_psi_pyramid(
            ident, tg, wg, live, wn, taps, 0.05, 0.2, 1024, 4e-3 * dim / 128.0, None,
            levels=3 if dim >= 256 else 2, warp_window=2, momentum=0.95, fine_window=1,
            stall_window=16, stall_rel=1e-2, fused=True, inverse_iters=3,
        )

    res = production_solve(tn)
    psi = res.psi
    warm = res.psi_inv.contiguous()  # the same frame's inverse (favourable)
    warm_prev = production_solve(prev_tn).psi_inv.contiguous()  # the previous frame's

    def mg(init, iters=3, fine_iters=1):
        return pyramid.estimate_inverse_multigrid(psi, iters, 2, init=init, fine_iters=fine_iters)

    q_cold = kernels.inverse_fixed_point(psi, 48, 2)
    rows = {
        "cold-48": q_cold,
        "warm-3 full-res": kernels.inverse_fixed_point(psi, 3, 2, warm),
        "multigrid c3+f1": mg(warm),
        "multigrid c3+f2": mg(warm, fine_iters=2),
        "warm-3 PREV-frame": kernels.inverse_fixed_point(psi, 3, 2, warm_prev),
        "multigrid PREV c3+f1": mg(warm_prev),
        # no fine anchor: what the no-log loop carries as the next warm start
        "multigrid PREV c3+f0": mg(warm_prev, fine_iters=0),
        "multigrid PREV c4+f0": mg(warm_prev, iters=4, fine_iters=0),
    }
    out = {}
    for name, q in rows.items():
        q = q.contiguous()
        dq = float(torch.max(torch.abs(q - q_cold)))
        r = float(torch.max(torch.abs(kernels.warp_field3(psi, q, 2) - ident)))
        print(f"{name:21s} max|q-q48| {dq:.2e} vox   resid {r:.2e} vox", flush=True)
        out[name] = {"max_dq_vox": dq, "resid_vox": r}
    return {"dim": dim, "psi_max_disp_vox": float(torch.max(torch.abs(psi - ident))),
            "rows": out, "platform": "gpu" if dev.type == "cuda" else "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dim", nargs="?", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.dim, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
