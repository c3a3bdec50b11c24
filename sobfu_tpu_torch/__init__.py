"""sobfu_tpu_torch — SobolevFusion on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of :mod:`sobfu_tpu` (the JAX/Pallas reference, which stays
as it is). Module and function names follow the JAX package so each
counterpart is easy to find:

- configuration / .ini parsing                  -> :mod:`sobfu_tpu_torch.config`
- depth preprocessing                           -> :mod:`sobfu_tpu_torch.ops.imgproc`
- TSDF volumes                                  -> :mod:`sobfu_tpu_torch.tsdf`
- deformation fields, samplers, stencils        -> :mod:`sobfu_tpu_torch.fields`
- the Sobolev gradient-descent solver           -> :mod:`sobfu_tpu_torch.solver`
- the pyramid's resamples, multigrid inverse    -> :mod:`sobfu_tpu_torch.pyramid`
- the CUDA kernels and their plain versions     -> :mod:`sobfu_tpu_torch.ops.kernels`
- marching cubes                                -> :mod:`sobfu_tpu_torch.mc`
- the frame loop                                -> :mod:`sobfu_tpu_torch.pipeline`
- the scene-batched frame step (one device)     -> :mod:`sobfu_tpu_torch.parallel`

It imports torch, numpy and the standard library only. Tensors on a CUDA
device run through the hand-written kernels in ``csrc/`` (built with nvcc
at first use into ``_build/``); tensors on the CPU run the plain torch
versions the kernels are checked against.
"""

from sobfu_tpu_torch.config import Intr, Params, load_params
from sobfu_tpu_torch.fields import DeformationField
from sobfu_tpu_torch.pipeline import SobFusion
from sobfu_tpu_torch.tsdf import TsdfVolume

__version__ = "0.1.0"

__all__ = [
    "Intr",
    "Params",
    "load_params",
    "TsdfVolume",
    "DeformationField",
    "SobFusion",
    "__version__",
]
