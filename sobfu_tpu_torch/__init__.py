"""sobfu_tpu_torch — SobolevFusion on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of :mod:`sobfu_tpu` (the JAX/Pallas reference, which stays
as it is). Module and function names follow the JAX package so each
counterpart is easy to find:

- configuration / .ini parsing                  -> :mod:`sobfu_tpu_torch.config`
- depth preprocessing (bilateral filter, truncation, dists, pyramids,
  normal/point maps, the rasteriser and renderers)
                                                -> :mod:`sobfu_tpu_torch.ops.imgproc`
- TSDF volumes (integration, fusion, analytic SDFs) -> :mod:`sobfu_tpu_torch.tsdf`
- deformation fields, samplers, stencils        -> :mod:`sobfu_tpu_torch.fields`
- the Sobolev gradient-descent solver           -> :mod:`sobfu_tpu_torch.solver`
- the pyramid's resamples, multigrid inverse    -> :mod:`sobfu_tpu_torch.pyramid`
- the CUDA kernels and their plain versions     -> :mod:`sobfu_tpu_torch.ops.kernels`
- marching cubes                                -> :mod:`sobfu_tpu_torch.mc`
- rigid projective ICP                          -> :mod:`sobfu_tpu_torch.icp`
- TSDF raycasting                               -> :mod:`sobfu_tpu_torch.raycast`
- the non-rigid frame loop                      -> :mod:`sobfu_tpu_torch.pipeline`
- the rigid KinectFusion pipeline               -> :mod:`sobfu_tpu_torch.kinfu`
- the pipelines (SobFusion, KinFu)              -> :mod:`sobfu_tpu_torch.models`
- scalar fields and the energy reductions       -> :mod:`sobfu_tpu_torch.scalar_fields`,
                                                   :mod:`sobfu_tpu_torch.reductor`
- the scene-batched and z-sharded frame steps   -> :mod:`sobfu_tpu_torch.parallel`
- device discovery, profiler traces             -> :mod:`sobfu_tpu_torch.core`

It imports torch, numpy and the standard library only. Tensors on a CUDA
device run through the hand-written kernels in ``csrc/`` (built with nvcc
at first use into ``_build/``); tensors on the CPU run the plain torch
versions the kernels are checked against.
"""

from sobfu_tpu_torch import icp, models, raycast
from sobfu_tpu_torch.config import Intr, Params, load_params
from sobfu_tpu_torch.fields import DeformationField
from sobfu_tpu_torch.kinfu import KinFu, KinFuParams
from sobfu_tpu_torch.pipeline import SobFusion
from sobfu_tpu_torch.reductor import Reductor
from sobfu_tpu_torch.scalar_fields import ScalarField
from sobfu_tpu_torch.tsdf import TsdfVolume

__version__ = "0.1.0"

__all__ = [
    "Intr",
    "Params",
    "load_params",
    "TsdfVolume",
    "DeformationField",
    "SobFusion",
    "ScalarField",
    "Reductor",
    "KinFu",
    "KinFuParams",
    "icp",
    "models",
    "raycast",
    "__version__",
]
