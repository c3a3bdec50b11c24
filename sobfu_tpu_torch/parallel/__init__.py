"""Scene batching on one device: the frame step over a batch of scenes."""

from sobfu_tpu_torch.parallel.sharding import FrameStep, make_frame_step

__all__ = ["FrameStep", "make_frame_step"]
