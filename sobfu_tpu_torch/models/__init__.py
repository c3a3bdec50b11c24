"""Model families: the reconstruction pipelines.

* :class:`SobFusion` — non-rigid SobolevFusion (reference
  src/sobfu/sob_fusion.cpp)
* :class:`KinFu` — rigid KinectFusion-style tracking + integration
  (reference src/kfusion/kinfu.cpp, completed into a working pipeline)
"""

from sobfu_tpu_torch.kinfu import KinFu, KinFuParams
from sobfu_tpu_torch.pipeline import SobFusion

__all__ = ["SobFusion", "KinFu", "KinFuParams"]
