"""Checkpoint / resume for a reconstruction run.

PyTorch counterpart of ``sobfu_tpu.utils.checkpoint``. The whole pipeline
state goes to one ``.npz`` with the JAX package's keys, dtypes and shapes,
so a checkpoint written by either package loads in the other: tensors come
off the device with ``.cpu().numpy()`` and go back onto ``fusion.device``.
(The reference keeps its state in GPU memory for the run only.)
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def state_dict(fusion) -> dict:
    """Pipeline state as a flat dict of numpy arrays.

    The complete cross-frame state: the four TSDF volumes (phi_global,
    phi_global_psi_inv, phi_n, phi_n_psi; the reference's four,
    sob_fusion.hpp:60-68), psi, psi_inv at its carry resolution (half
    resolution under Solver.inv_coarse), the poses, the frame counter and
    the two stale flags that tell the mesh getters to recompute. The
    solver's momentum and stall detector restart with every solve and are
    not stored.
    """
    state = {
        "frame_counter": np.asarray(fusion.frame_counter),
        "poses": np.stack(fusion.poses, axis=0),
    }
    if fusion.phi_global is not None:
        state["phi_global_tsdf"] = _host(fusion.phi_global.tsdf)
        state["phi_global_weight"] = _host(fusion.phi_global.weight)
        state["psi"] = _host(fusion.psi.data)
        state["psi_inv"] = _host(fusion.psi_inv.data)
        for name in ("phi_global_psi_inv", "phi_n", "phi_n_psi"):
            vol = getattr(fusion, name)
            state[f"{name}_tsdf"] = _host(vol.tsdf)
            state[f"{name}_weight"] = _host(vol.weight)
        state["inv_warps_stale"] = np.asarray(bool(fusion._inv_warps_stale))
        state["n_psi_weight_stale"] = np.asarray(bool(fusion._n_psi_weight_stale))
    return state


def save_checkpoint(path: str, fusion) -> None:
    """Serialise a SobFusion pipeline's state to ``path`` (.npz)."""
    tmp = path + ".tmp.npz"  # np.savez keeps a name that ends in .npz
    np.savez_compressed(tmp, **state_dict(fusion))
    os.replace(tmp, path)


def load_checkpoint(path: str, fusion) -> None:
    """Restore a SobFusion pipeline's state in place from ``path``."""
    with np.load(path) as data:
        _restore(data, fusion)


def save_checkpoint_orbax(path: str, fusion) -> None:
    """The orbax-named entry point of ``sobfu_tpu.utils.checkpoint``.

    Orbax is a JAX library and this package imports no JAX, so this is the
    branch the JAX package itself takes when ``import orbax.checkpoint``
    fails: the ``.npz`` of :func:`save_checkpoint`.
    """
    save_checkpoint(path, fusion)


def load_checkpoint_orbax(path: str, fusion) -> None:
    """The ``.npz`` reader, as :func:`save_checkpoint_orbax` explains."""
    load_checkpoint(path, fusion)


def _restore(data, fusion) -> None:
    from sobfu_tpu_torch import solver as solver_mod
    from sobfu_tpu_torch.fields import DeformationField
    from sobfu_tpu_torch.tsdf import TsdfVolume

    dev = fusion.device

    def tensor(key):
        return torch.from_numpy(np.array(data[key])).to(dev)

    def field(key):
        arr = tensor(key)
        _, Z, Y, X = arr.shape  # dims from the array: psi_inv may be the half-res carry
        return DeformationField((X, Y, Z), arr, device=dev)

    fusion.frame_counter = int(data["frame_counter"])
    fusion.poses = [pose for pose in np.asarray(data["poses"])]
    if "phi_global_tsdf" in data:
        p = fusion.params
        for name in ("phi_global", "phi_global_psi_inv", "phi_n", "phi_n_psi"):
            vol = TsdfVolume(p, dev)
            if f"{name}_tsdf" in data:  # a checkpoint older than the four volumes has one
                vol.tsdf, vol.weight = tensor(f"{name}_tsdf"), tensor(f"{name}_weight")
            setattr(fusion, name, vol)
        for flag in ("inv_warps_stale", "n_psi_weight_stale"):
            setattr(fusion, f"_{flag}", bool(data[flag]) if flag in data else False)
        fusion.psi = field("psi")
        fusion.psi_inv = field("psi_inv")
        fusion.solver = solver_mod.Solver(p)
