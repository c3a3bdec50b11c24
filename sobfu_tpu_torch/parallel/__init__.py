"""The frame step over a batch of scenes, on one device or over a
('scene', 'z') mesh, and the z-sharded solve (``sobfu_tpu.parallel``)."""

from sobfu_tpu_torch.parallel.sharding import FrameStep, make_frame_step
from sobfu_tpu_torch.parallel.zshard import (
    Mesh,
    ShardedFrameStep,
    estimate_psi_sharded,
    make_mesh,
    make_sharded_estimate_psi,
)

__all__ = [
    "FrameStep",
    "Mesh",
    "ShardedFrameStep",
    "estimate_psi_sharded",
    "make_frame_step",
    "make_mesh",
    "make_sharded_estimate_psi",
]
