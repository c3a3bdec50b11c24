"""KinFu: rigid KinectFusion-style tracking and integration.

PyTorch counterpart of ``sobfu_tpu.kinfu`` (reference
include/kfusion/kinfu.hpp, src/kfusion/kinfu.cpp, whose ``operator()`` is
declared and never defined; the JAX package completes it):

  depth -> bilateral filter -> truncation -> dists + point/normal pyramids
        -> projective ICP against the previous frame's pyramids (or, with
           ``track_against_model``, against a raycast of the fused TSDF)
        -> TSDF integration at the tracked pose

Every step runs in plain torch on the volume's device, the card by
default. A frame reads the ICP flags (one per pyramid level) and the pose
increment to the host, as the JAX package does.

Three steps differ from the JAX package, whose KinFu is wrong in each
(ROADMAP Queue 3; ``tests/test_torch_kinfu.py`` shows each and holds the
port to the JAX package with all three corrected):

* the pose: ICP's increment maps the current frame's points into the
  previous frame, so the new camera-to-world pose is previous @ Tinc; JAX
  composes previous @ inv(Tinc), which moves the camera against its motion;
* the integrated map: ``TsdfVolume.integrate`` takes psdf = Dp - z_cam
  (the reference's integrator, shared with the non-rigid path), so Dp must
  be the depth along camera z; JAX passes the ray lengths
  (``compute_dists``, depth * sqrt(1 + xl^2 + yl^2)), which pushes the
  surface back off the optical axis (by 9.5 cm at 1.5 m, 0.3 of the focal
  length off-centre), and frame-to-model tracking against that surface
  diverges. The port integrates the filtered depth in metres;
* the pixel a voxel reads: the integrator reads the floor pixel of its
  projection, while pixel i's ray passes through coordinate i (cx = W/2 -
  0.5), so the fused surface sits half a pixel off the depth map and
  frame-to-model tracking drifts by that much a frame (8 mm a frame at
  160x120 and 128^3 on a CPU run). KinFu integrates with the principal
  point moved by half a pixel, which makes the floor pixel the nearest one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from sobfu_tpu_torch.config import Intr, Params, translation_pose
from sobfu_tpu_torch.core import resolve_device
from sobfu_tpu_torch.icp import ProjectiveICP
from sobfu_tpu_torch.ops import imgproc
from sobfu_tpu_torch.raycast import raycast_volume
from sobfu_tpu_torch.tsdf import TsdfVolume


@dataclasses.dataclass
class KinFuParams:
    """Field-for-field parity with reference KinFuParams (kinfu.hpp:21-53)."""

    cols: int = 640
    rows: int = 480
    intr: Intr = Intr(525.0, 525.0, 640 / 2 - 0.5, 480 / 2 - 0.5)

    volume_dims: Tuple[int, int, int] = (512, 512, 512)
    volume_size: Tuple[float, float, float] = (3.0, 3.0, 3.0)
    volume_pose: np.ndarray = dataclasses.field(
        default_factory=lambda: translation_pose((-1.5, -1.5, 0.5))
    )

    bilateral_sigma_depth: float = 0.04
    bilateral_sigma_spatial: float = 4.5
    bilateral_kernel_size: int = 7

    icp_truncate_depth_dist: float = 0.0
    icp_dist_thres: float = 0.1
    icp_angle_thres: float = np.deg2rad(30.0)
    icp_iter_num: Tuple[int, ...] = (10, 5, 4, 0)

    tsdf_min_camera_movement: float = 0.0
    tsdf_trunc_dist: float = 0.04
    tsdf_max_weight: float = 64.0

    raycast_step_factor: float = 0.75
    gradient_delta_factor: float = 0.5

    light_pose: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # True = frame-to-model tracking: ICP against the raycast TSDF
    track_against_model: bool = False

    @staticmethod
    def default_params() -> "KinFuParams":
        """Reference defaults (kinfu.cpp:10-44)."""
        return KinFuParams()


class KinFu:
    """Rigid KinectFusion-style pipeline on ``device`` (the card by
    default; without one it raises, pass ``device="cpu"`` for the CPU)."""

    def __init__(self, params: KinFuParams = None, device="cuda"):
        self.device = resolve_device(device)
        self.params_ = params if params is not None else KinFuParams.default_params()
        p = self.params_
        vol_params = Params(
            cols=p.cols,
            rows=p.rows,
            volume_dims=p.volume_dims,
            volume_size=p.volume_size,
            volume_pose=p.volume_pose,
            intr=p.intr,
            tsdf_trunc_dist=p.tsdf_trunc_dist,
            eta=p.tsdf_trunc_dist,  # the rigid path has no eta; reuse the band
            tsdf_max_weight=p.tsdf_max_weight,
            gradient_delta_factor=p.gradient_delta_factor,
        )
        self.volume_ = TsdfVolume(vol_params, device=self.device)
        self.icp_ = ProjectiveICP()
        self.icp_.dist_thres = p.icp_dist_thres
        self.icp_.angle_thres = p.icp_angle_thres
        self.icp_.set_iterations(p.icp_iter_num)

        self.frame_counter_ = 0
        self.poses_: List[np.ndarray] = [np.eye(4, dtype=np.float32)]
        self._prev_points = None
        self._prev_normals = None

    # -- accessors (kinfu.cpp:47-62) ----------------------------------------
    def params(self) -> KinFuParams:
        return self.params_

    def tsdf(self) -> TsdfVolume:
        return self.volume_

    def icp(self) -> ProjectiveICP:
        return self.icp_

    def reset(self) -> None:
        """Reference KinFu::reset (kinfu.cpp:100-109)."""
        if self.frame_counter_:
            print("Reset")
        self.frame_counter_ = 0
        self.poses_ = [np.eye(4, dtype=np.float32)]
        self.volume_.clear()
        self._prev_points = None
        self._prev_normals = None

    def get_camera_pose(self, time: int = -1) -> np.ndarray:
        """Reference KinFu::getCameraPose (kinfu.cpp:111-117); ``>=`` where
        the reference has ``>``, whose time == len(poses) reads past the end."""
        if time >= len(self.poses_) or time < 0:
            time = len(self.poses_) - 1
        return self.poses_[time]

    # -- per-frame step ------------------------------------------------------
    def _integrate(self, filtered: torch.Tensor, pose: np.ndarray) -> None:
        """Integrate the depth map at ``pose``: metres along camera z, what
        the integrator's psdf = Dp - z_cam compares, each voxel reading the
        pixel nearest to its projection (see the module doc)."""
        i = self.params_.intr
        self.volume_.integrate(filtered.to(torch.float32) * 0.001, pose,
                               Intr(i.fx, i.fy, i.cx + 0.5, i.cy + 0.5))

    def _model_maps(self):
        """Point and normal pyramids of a raycast of the fused TSDF from the
        last pose, NaN where no surface was hit (frame-to-model tracking)."""
        p = self.params_
        points, normals = [], []
        for lvl in range(self.icp_.used_levels()):
            _, pts, nrm = raycast_volume(
                self.volume_, self.poses_[-1], p.intr.level(lvl),
                p.rows >> lvl, p.cols >> lvl, p.raycast_step_factor,
            )
            invalid = (torch.abs(pts[..., 2]) <= 0)[..., None]
            points.append(torch.where(invalid, float("nan"), pts))
            normals.append(torch.where(invalid, float("nan"), nrm))
        return points, normals

    def __call__(self, depth) -> bool:
        """Process one depth frame (mm; a numpy uint16 array or a tensor):
        track rigidly and integrate. Returns True when tracking succeeded
        (always for frame 0); on failure the pipeline resets."""
        p = self.params_
        if isinstance(depth, np.ndarray):
            depth = torch.from_numpy(depth.astype(np.int32))
        depth = depth.to(device=self.device, dtype=torch.int32)
        filtered = imgproc.bilateral_filter(
            depth, p.bilateral_kernel_size, p.bilateral_sigma_spatial, p.bilateral_sigma_depth
        )
        if p.icp_truncate_depth_dist > 0:
            filtered = imgproc.truncate_depth(filtered, p.icp_truncate_depth_dist)

        _, points, normals = self.icp_.build_pyramid(
            filtered, p.intr, max(self.icp_.used_levels(), 1), p.bilateral_sigma_depth
        )
        if self.frame_counter_ == 0:
            self._integrate(filtered, self.poses_[-1])
            self._prev_points, self._prev_normals = points, normals
            self.frame_counter_ += 1
            return True

        if p.track_against_model:
            prev_points, prev_normals = self._model_maps()
        else:
            prev_points, prev_normals = self._prev_points, self._prev_normals
        Tinc, ok = self.icp_.estimate_transform(p.intr, points, normals, prev_points,
                                                prev_normals)
        if not ok:
            self.reset()
            return False

        # Tinc maps this frame's points into the previous frame (module doc)
        pose = (self.poses_[-1] @ Tinc).astype(np.float32)
        self.poses_.append(pose)
        if np.linalg.norm(Tinc[:3, 3]) >= p.tsdf_min_camera_movement:
            self._integrate(filtered, pose)
        self._prev_points, self._prev_normals = points, normals
        self.frame_counter_ += 1
        return True
