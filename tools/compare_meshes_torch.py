"""Compare two triangle meshes (.vtk): symmetric point-distance RMSE.

The port's sibling of tools/compare_meshes.py: the same samples, distances
and JSON, the meshes read with sobfu_tpu_torch.io (nothing of JAX is
imported):

    python tools/compare_meshes_torch.py ours.vtk theirs.vtk [--samples 20000]

Prints JSON with RMSE / mean / p95 / max of nearest-neighbour distances
between vertex samples in both directions (a proxy for surface distance at
marching-cubes resolution).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from tools.compare_meshes import _nn_dists, _sample


def compare(path_a: str, path_b: str, samples: int = 20000) -> dict:
    from sobfu_tpu_torch.io import load_mesh_vtk

    va = _sample(load_mesh_vtk(path_a).vertices, samples)
    vb = _sample(load_mesh_vtk(path_b).vertices, samples, seed=1)
    d_ab = _nn_dists(va, vb)
    d_ba = _nn_dists(vb, va)
    d = np.concatenate([d_ab, d_ba])
    return {
        "a": path_a,
        "b": path_b,
        "n_a": int(va.shape[0]),
        "n_b": int(vb.shape[0]),
        "rmse": float(np.sqrt((d**2).mean())),
        "mean": float(d.mean()),
        "p95": float(np.percentile(d, 95)),
        "max": float(d.max()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mesh_a")
    ap.add_argument("mesh_b")
    ap.add_argument("--samples", type=int, default=20000)
    args = ap.parse_args(argv)
    print(json.dumps(compare(args.mesh_a, args.mesh_b, args.samples), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
